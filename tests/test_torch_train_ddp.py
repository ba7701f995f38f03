"""The port's data-parallel step (``hipad_torch/parallel/mesh.py`` through
``make_train_step(group=)``) in two gloo processes on the CPU, each on its
half of a global batch of 4 at ``tiny()``, fp32, against one process on the
global batch and against the JAX package's one-device step on it (the
JAX package's sharded step is one program over the global batch,
``tests/test_sharding_equivalence.py``): losses and gradient norm, every
gradient leaf, running statistics, banks and the parameters after the
update, with the tolerances of ``test_torch_train_step.py``; and the two
ranks' parameters after the update equal bit for bit.

The parent draws the global batch and the banks (one eval frame of the port
on it) once and hands each child its slice in a file; each child finds its
group at a port the parent picked free for this test. The two processes
fix ``PYTHONHASHSEED``, though the batch is drawn in the parent
(``data/synthetic.py`` orders the plan GT by a Python set)."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.parallel import mesh
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
from test_torch_train_stage1 import (NO_DROP, assert_step_matches, jax_step, port_result,
                                     step_batch, warm_banks)
from test_torch_train_step import _port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, GLOBAL_BS = 2, 4
CHILD_TIMEOUT_S = 600

_CHILD = r"""
import pickle, sys
import torch
torch.set_num_threads(1)
from hipad_torch.models.detector import HiPAD
from hipad_torch.parallel import mesh
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
with open(src, "rb") as f:
    job = pickle.load(f)
cfg = job["cfg"]
dp = mesh.init("gloo", f"tcp://localhost:{port}", job["world"], rank)
model = HiPAD(cfg, device="cpu", group=dp.group)
model.load_state_dict(job["state_dict"])
for m in model.modules():
    if hasattr(m, "attn_drop"):
        m.attn_drop = 0.0
opt = AdamW(model.named_parameters())
step = make_train_step(cfg, model, opt, group=dp.group)
batch = {k: torch.as_tensor(v) for k, v in job["batches"][rank].items()}
banks, metrics = step(job["banks"][rank], batch, torch.Generator().manual_seed(0))
out = {"metrics": {k: float(v) for k, v in metrics.items()},
       "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
       "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
       "banks": banks}
mesh.shutdown(dp)
with open(dst, "wb") as f:
    pickle.dump(out, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def at_most_one_box_per_anchor(cfg, batch):
    """Keep the first ``num_det_anchor`` valid GT boxes of each sample.

    With more valid GT rows than det predictions (possible only at tiny()'s
    12 anchors; stage 2 has 900 for at most 32 boxes), the JAX package's
    fp32 Jonker-Volgenant matcher can return an assignment a little above
    the optimum that scipy finds: on this batch, layer 2's det matching of
    sample 3 costs 126.8255 against scipy's 126.8232, and the motion loss,
    which reuses that matching, then differs by 2% (ROADMAP queue 3,
    "Ties")."""
    valid = batch["gt_valid"] & (np.arange(batch["gt_valid"].shape[1]) < cfg.num_det_anchor)
    return dict(batch, gt_valid=valid,
                gt_agent_fut_masks=batch["gt_agent_fut_masks"] * valid[..., None])


def _slice_banks(banks, rank):
    import dataclasses

    from hipad_torch.models.instance_bank import BankStates

    per = GLOBAL_BS // WORLD
    return BankStates(*(dataclasses.replace(s, **{
        f.name: getattr(s, f.name)[rank * per:(rank + 1) * per].clone()
        for f in dataclasses.fields(s)}) for s in (banks.det, banks.ego, banks.plan)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = tiny(**NO_DROP)
    model = _port(cfg)
    for m in model.modules():
        if hasattr(m, "attn_drop"):
            m.attn_drop = 0.0
    raw = at_most_one_box_per_anchor(cfg, synthetic.make_batch(cfg, GLOBAL_BS, seed=21))
    banks = warm_banks(model, raw)
    batch = step_batch(raw)
    sd = {k: v.clone() for k, v in model.state_dict().items()}

    tmp = tmp_path_factory.mktemp("ddp")
    job = {"cfg": cfg, "world": WORLD, "state_dict": sd,
           "batches": [mesh.local_batch(batch, r, WORLD) for r in range(WORLD)],
           "banks": [_slice_banks(banks, r) for r in range(WORLD)]}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONHASHSEED="0", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r), port, str(tmp / "job.pkl"),
                               str(tmp / f"out{r}.pkl")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    # one process on the global batch, from the same weights and banks
    opt = AdamW(model.named_parameters())
    new_banks, metrics = make_train_step(cfg, model, opt)(
        banks, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    single = port_result(model, metrics, new_banks)
    ref = jax_step(cfg, sd, batch, banks)
    return {"cfg": cfg, "ranks": ranks, "single": single, "jax": ref}


def _ddp_result(runs):
    """Rank 0's parameters and gradients (equal on both ranks), its metrics
    (the global ones) and both ranks' banks joined into the global batch's."""
    import dataclasses

    from hipad_torch.models.instance_bank import BankStates

    ranks = runs["ranks"]
    banks = BankStates(*(type(getattr(ranks[0]["banks"], n))(**{
        f.name: torch.cat([getattr(getattr(r["banks"], n), f.name) for r in ranks])
        for f in dataclasses.fields(getattr(ranks[0]["banks"], n))})
        for n in ("det", "ego", "plan")))
    model = _port(runs["cfg"])
    model.load_state_dict(ranks[0]["state_dict"])
    for n, p in model.named_parameters():
        p.grad = ranks[0]["grads"][n]
    return port_result(model, ranks[0]["metrics"], banks)


def test_ranks_end_with_identical_parameters(runs):
    a, b = runs["ranks"]
    assert a["metrics"] == b["metrics"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k


def test_two_processes_match_one_process_on_the_global_batch(runs):
    assert_step_matches(_ddp_result(runs), runs["single"], "ddp vs one process ")


def test_two_processes_match_jax_on_the_global_batch(runs):
    assert_step_matches(_ddp_result(runs), runs["jax"], "ddp vs jax ")
