"""The gather probes P2-P4: the Pallas kernels of
``tools/probe_pallas_gather.py`` (interpret mode on the CPU, through a proxy
for the module's ``pl``; no file of the tool changes) against the port's
plain versions (``hipad_torch/ops/gather.py``), bit for bit: every probe is a
copy of whole rows."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.ops import gather, kernels
from hipad_torch.tools import probe_gather

ROOT = pathlib.Path(__file__).resolve().parent.parent
M_SMALL = 512  # indices per call: two grid steps of the probes' 256-row tile


class _InterpretPallas:
    """Stands in for ``jax.experimental.pallas`` inside the tool: every
    ``pallas_call`` runs in interpret mode on the CPU."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_gather", ROOT / "tools" / "probe_pallas_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _InterpretPallas(mod.pl)
    mod.M = M_SMALL  # the probes read M when they are built
    return mod


@pytest.mark.parametrize("which", ["A", "D", "C"])
def test_pallas_probe_interpret_equals_port(tool, which):
    """The tool's own data recipe at M=512, with rows 0 and N-1 among the
    indices; the Pallas output and the port's plain version agree exactly."""
    rng = np.random.RandomState(0)
    rows = rng.randn(tool.N, gather.ROW).astype(np.float32)
    idx = rng.randint(0, tool.N, M_SMALL).astype(np.int32)
    idx[:16:8] = (0, tool.N - 1)  # both ends, also on P4's every-8th indices
    run, prep, _ = {"A": tool.probe_a, "D": tool.probe_d, "C": tool.probe_c}[which]()
    ref = np.asarray(run(jnp.asarray(idx), prep(rows)).astype(jnp.float32))
    fn = gather.PROBES[which][0]
    got = fn(torch.from_numpy(idx), gather.make_table(which, rows, "cpu"))
    assert got.dtype == gather.PROBES[which][1]
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("which", ["A", "D", "C"])
def test_probe_tool_runs_the_plain_versions_on_the_cpu(which):
    """The port's tool at its own sizes on the CPU: right shapes, and the
    output equals the table's own rows (``correct=True``)."""
    out, ref, correct, ms = probe_gather.run(which, device="cpu")
    assert correct and ms is None
    assert out.shape == (probe_gather.M // gather.PROBES[which][3], gather.ROW)


def test_row_gather_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never compute on the CPU."""
    table = torch.zeros(4, 8, 128)
    idx = torch.zeros(3, dtype=torch.int32)
    for k in (kernels.gather_rows_f32, kernels.gather_rows_bf16,
              kernels.gather_rows_f32_every8):
        with pytest.raises(ValueError, match="CUDA"):
            k(table.to(k.dtype), idx)
        assert k.launches == 0


@pytest.mark.parametrize("n_out", [
    8192,  # P2 and P3: every one of the probe tool's 8,192 indices
    1024,  # P4: every 8th index
    1023,  # a ragged count: the last block holds 3 rows
    1,
])
def test_row_gather_geometry(n_out):
    """Two warps a row, four rows a 256-thread block: the blocks cover the
    output rows once, the last one possibly ragged."""
    rows, blocks = kernels.row_gather_geometry(n_out)
    assert rows == 4
    assert (blocks - 1) * rows < n_out <= blocks * rows
