"""The port's checkpoints (``hipad_torch/train/checkpoint.py``) at ``tiny()``
on the CPU: the round trip that ``tests/test_checkpoint.py`` holds the JAX
package's orbax checkpoints to (save, restore, ``load_params_only``,
``load_variables``, ``keep``), and a training run broken by a save and a
restore into a fresh model, which must equal the unbroken run bit for bit:
losses, gradient norm, parameters, running statistics and banks (the CPU
runs the same operations in the same order, so the tolerance is zero).
Dropout and GridMask are on, so the generator's state is part of what the
checkpoint must carry."""

import dataclasses
import os

import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models.detector import HiPAD
from hipad_torch.models.instance_bank import init_bank_states
from hipad_torch.train import checkpoint
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
from hipad_torch.weights import init_random

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _fresh(cfg, seed):
    model = init_random(HiPAD(cfg, device="cpu"), seed)
    return model, AdamW(model.named_parameters(), total_steps=10)


def _batch(cfg, i):
    b = synthetic.make_batch(cfg, 1, seed=i)
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _banks_equal(a, b):
    for n in ("det", "ego", "plan"):
        for f in dataclasses.fields(getattr(a, n)):
            x, y = getattr(getattr(a, n), f.name), getattr(getattr(b, n), f.name)
            assert x.dtype == y.dtype and torch.equal(x, y), f"bank {n}.{f.name}"


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny()
    model, opt = _fresh(cfg, 0)
    gen = torch.Generator().manual_seed(5)
    banks, _ = make_train_step(cfg, model, opt)(None, _batch(cfg, 0), gen)
    checkpoint.save_checkpoint(str(tmp_path), 7, model, opt, banks, gen)

    fresh, fresh_opt = _fresh(cfg, 1)
    fresh_gen = torch.Generator().manual_seed(99)
    restored = checkpoint.restore_checkpoint(str(tmp_path), fresh, fresh_opt, fresh_gen)
    assert restored["step"] == 7
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert fresh_opt.count == opt.count == 1
    for name in ("mu", "nu"):
        for a, b in zip(getattr(fresh_opt, name), getattr(opt, name)):
            assert torch.equal(a, b)
    assert torch.equal(fresh_gen.get_state(), gen.get_state())
    _banks_equal(restored["banks"], banks)

    # params-only warm start keeps a fresh optimizer
    warm, warm_opt = _fresh(cfg, 2)
    assert checkpoint.load_params_only(str(tmp_path), warm) == []
    assert warm_opt.count == 0 and all(not m.any() for m in warm_opt.mu)
    for k, v in model.state_dict().items():
        assert torch.equal(warm.state_dict()[k], v), k

    # inference-only variables: the same tensors, without an optimizer
    variables = checkpoint.load_variables(str(tmp_path))
    assert set(variables) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(variables[k], v), k


def test_keep_and_latest_step(tmp_path):
    cfg = tiny()
    model, opt = _fresh(cfg, 0)
    for step in (2, 4, 6):
        checkpoint.save_checkpoint(str(tmp_path), step, model, opt, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["4", "6"]
    assert checkpoint.latest_step(str(tmp_path)) == 6
    with pytest.raises(FileNotFoundError, match="step 2"):
        checkpoint.load_variables(str(tmp_path), step=2)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        checkpoint.load_variables(str(tmp_path / "empty"))


def test_accumulation_banks_round_trip(tmp_path):
    """A list of bank slices (gradient accumulation) and bf16 bank features
    come back as they went in."""
    cfg = tiny()
    model, opt = _fresh(cfg, 0)
    banks = [init_bank_states(cfg, 2, "cpu", feature_dtype=torch.bfloat16) for _ in range(2)]
    banks[1].det.confidence.fill_(0.5)
    checkpoint.save_checkpoint(str(tmp_path), 1, model, opt, banks)
    got = checkpoint.restore_checkpoint(str(tmp_path), *_fresh(cfg, 1))["banks"]
    assert len(got) == 2
    for a, b in zip(got, banks):
        _banks_equal(a, b)


def test_resumed_run_equals_the_unbroken_one(tmp_path):
    cfg = tiny(drop_out=0.1)  # dropout and GridMask on: they draw from the generator

    def run(model, opt, gen, banks, steps):
        step = make_train_step(cfg, model, opt)
        for i in steps:
            banks, metrics = step(banks, _batch(cfg, i), gen)
        return banks, {k: v.clone() for k, v in metrics.items()}

    model, opt = _fresh(cfg, 0)
    gen = torch.Generator().manual_seed(1)
    banks, unbroken = run(model, opt, gen, None, range(3))

    model2, opt2 = _fresh(cfg, 0)
    gen2 = torch.Generator().manual_seed(1)
    banks2, _ = run(model2, opt2, gen2, None, range(2))
    checkpoint.save_checkpoint(str(tmp_path), 2, model2, opt2, banks2, gen2)
    del model2, opt2, gen2, banks2

    model3, opt3 = _fresh(cfg, 3)  # other weights, overwritten by the restore
    gen3 = torch.Generator().manual_seed(42)
    restored = checkpoint.restore_checkpoint(str(tmp_path), model3, opt3, gen3)
    assert restored["step"] == 2
    banks3, resumed = run(model3, opt3, gen3, restored["banks"], range(2, 3))

    assert set(resumed) == set(unbroken)
    for k in unbroken:
        assert torch.equal(resumed[k], unbroken[k]), (k, float(resumed[k]), float(unbroken[k]))
    for k, v in model.state_dict().items():
        assert torch.equal(model3.state_dict()[k], v), k
    _banks_equal(banks3, banks)
