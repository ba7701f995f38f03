"""Gradient accumulation in the port (``make_accum_train_step``) against the
JAX package's (``make_accum_train_step`` under ``jit``, as
``jit_train_step(accum_steps=2)`` runs it) at ``tiny()``, A=2 micro-batches
of bs=2, fp32 on the CPU, each micro-batch with its own bank slice (the
banks of one eval frame of the port on it), one AdamW update: losses and
gradient norm (the micro-steps' mean), running statistics carried through
both micro-steps, each slice's new banks, and the parameters after the
update, with the tolerances of ``test_torch_train_step.py``.

And, on the port alone: the accumulated step equals the mean of the two
micro-batches' gradients applied once (``tests/test_grad_accum.py``'s
spec), and only one micro-step's activations are live at a time."""

import os
import weakref

import numpy as np
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_accum_train_step, make_train_step
from test_torch_train_stage1 import (NO_DROP, assert_step_matches, jax_step, port_result,
                                     step_batch, warm_banks)
from test_torch_train_step import _port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

A, BS = 2, 2


def _setup():
    cfg = tiny(**NO_DROP)
    model = _port(cfg)
    raw = [synthetic.make_batch(cfg, BS, seed=10 + a) for a in range(A)]
    banks = [warm_banks(model, b) for b in raw]
    return cfg, model, [step_batch(b) for b in raw], banks


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_accumulated_step_matches_jax():
    cfg, model, batches, banks = _setup()
    ref = jax_step(cfg, model.state_dict(), batches, banks, accum=A)
    step = make_accum_train_step(cfg, model, AdamW(model.named_parameters()), A)
    new_banks, metrics = step(banks, [_tensors(b) for b in batches],
                              torch.Generator().manual_seed(0))
    assert len(new_banks) == A
    assert_step_matches(port_result(model, metrics, new_banks, with_grads=False), ref,
                        "accum ")


def test_accumulation_is_the_mean_of_the_micro_gradients():
    """Against two plain steps' gradients on the same weights, averaged and
    applied once: equal to fp32 rounding (the sum runs in another order)."""
    cfg, model, batches, banks = _setup()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    state, grads, losses = sd, [], []
    for a in range(A):
        model.load_state_dict(state)
        opt = AdamW(model.named_parameters())
        _, m = make_train_step(cfg, model, opt)(banks[a], _tensors(batches[a]),
                                                torch.Generator().manual_seed(0))
        grads.append([p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                      for p in opt.params])
        losses.append(float(m["total_loss"]))
        # the same weights for the next micro-batch; the running statistics
        # carry over, as in the accumulated step
        state = {**sd, **{k: v.clone() for k, v in model.state_dict().items()
                          if "running" in k}}
    model.load_state_dict(sd)
    opt = AdamW(model.named_parameters())
    _, metrics = make_accum_train_step(cfg, model, opt, A)(
        banks, [_tensors(b) for b in batches], torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(metrics["total_loss"]), np.mean(losses), rtol=1e-6)
    for p, *gs in zip(opt.params, *grads):
        mean = sum(gs) / A
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        assert torch.allclose(got, mean, rtol=1e-5, atol=1e-7 * float(mean.abs().max()) + 1e-12)


def test_one_micro_steps_activations_live_at_a_time(monkeypatch):
    """The second micro-step's forward starts after the first one's backward
    has freed its graph: no tensor saved for backward outlives its micro-step."""
    from hipad_torch.models import detector

    cfg, model, batches, banks = _setup()
    live, seen = [], []
    forward = detector.HiPAD.forward

    def counting(self, *args, **kwargs):
        seen.append(sum(1 for t in live if t() is not None))
        out = forward(self, *args, **kwargs)
        live.append(weakref.ref(out[0]["plan"]["final_waypoints"]))
        return out

    monkeypatch.setattr(detector.HiPAD, "forward", counting)
    make_accum_train_step(cfg, model, AdamW(model.named_parameters()), A)(
        banks, [_tensors(b) for b in batches], torch.Generator().manual_seed(0))
    assert seen == [0, 0], seen
