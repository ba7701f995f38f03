"""Build, bind and launch the port's CUDA kernels: the sampler's K1 (every
coarse level in one launch) and K2 (the fine levels) forward, K1-bwd and
K2-bwd for their gradients, K2's and K2-bwd's level-k variants (each sample
reads only its kept fine levels: ``sampler_level_k``), the sampler's glue
around K1 and K2 on a frame that needs no gradient (the camera selection
before K2, the point sum after K1), the row gather that stands in for the
Pallas gather probes P2-P4, and K3, the training step's batched assignment
solver.

The sources ``hipad_torch/csrc/*.cu`` are compiled with plain ``nvcc`` for
``sm_90a``, one ``nvcc`` per source and all started together, then linked
into one shared library with a C interface, on first use, into
``build/hipad_torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``. Nothing here runs at import time: the CPU tests import this
module on hosts without a card or a compiler.

Each wrapper checks device, dtype, shape, contiguity and alignment, raises
on anything its kernel does not take, allocates its outputs and scratch
(``torch.empty``: every element is written by the kernels), launches on
PyTorch's current stream and raises if the launch reports a CUDA error.
Each keeps ``launches``, the number of calls that launched its kernel, so a
run can show that the main path went through the kernel.

No kernel adds with float atomics into an output that several threads
share: each sums in an order that its inputs alone fix, so a call gives the
same bits on every run, with torch's deterministic flag
(``torch.use_deterministic_algorithms(True)``) on or off, and every wrapper
has one design.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import os
import pathlib
import shutil
import subprocess
import time
from typing import NamedTuple, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "hipad_torch_kernels"
LIB_NAME = "libhipad_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VEC = 8  # channels per lane per load (csrc/sample_common.cuh: kVec)
_MAX_C = 1024  # 32 lanes * kVec * kMaxChunks
_MAX_LEVELS = 4  # fine levels of K2, coarse levels of K1
_WARPS = 4  # warps per block of the forward kernels (kFwdWarps)
_MAX_PAIRS = 32  # K1's (level, camera) or K2's (slot, level) pairs: one a lane
_STATIC_SMEM = 48 * 1024  # shared memory a launch takes without opting in


def _forward_smem_bytes(pairs: int, G: int) -> int:
    """Shared memory of one block of K1 or K2 (``csrc/sample_common.cuh:
    warp_smem_bytes``): per warp, a list of up to 4 taps of 16 bytes per
    pair and the pairs' G group weights in fp32, rounded up to 16 bytes."""
    return _WARPS * ((pairs * 4 * 16 + pairs * G * 4 + 15) // 16 * 16)

_SMEM_PER_BLOCK = 232_448  # shared memory an H100 block may opt in to (K3's plan)


# The binned scatter of K1-bwd and K2-bwd (csrc/bin_scatter.cuh): items a
# chunk of the counts (a place block's threads), the counts (bins x chunks)
# the plan allows an item, and the taps a cell below which a warp takes a
# run of 4 cells.
_BIN_CHUNK = 512
_BIN_COUNTS_PER_ITEM = 16
_BIN_RUN_TAPS = 8
_BIN_SLICE_TAPS = 32  # taps a cell per warp above which a cell's items are split
_BIN_MAX_SPLIT = 8  # warps a cell at most: one block's
_BIN_ITEM_BYTES = 16  # BinItem: x, y, its weights' and upstream rows


class CellsPlan(NamedTuple):
    """One map size of a binned launch: bins of ``sw`` columns (``nseg`` a
    row), ``rowbins`` bin rows a map from top tap row ``tb0``, its first bin
    ``bin0``, and the first warp ``warp0`` of its cells."""

    sw: int
    nseg: int
    rowbins: int
    tb0: int
    bin0: int
    warp0: int


class BinPlan(NamedTuple):
    """A binned launch (``csrc/bin_scatter.cuh``): each map size's
    :class:`CellsPlan`, ``nbins`` bins, ``items`` and their ``chunks`` of the
    counts, ``ow`` cells a run, ``warps`` runs of the cells kernel and
    ``split`` warps a run (slices of its items, summed in order)."""

    levels: tuple
    nbins: int
    items: int
    chunks: int
    ow: int
    warps: int
    split: int

    def host_ints(self) -> list:
        """The plan as ``hipad::read_plan`` reads it."""
        head = [self.nbins, self.chunks, self.warps, self.ow, self.split, len(self.levels)]
        return head + [v for t in self.levels for v in (t.sw, t.tb0, t.rowbins, t.bin0, t.warp0)]


def bin_plan(maps: int, sizes: Sequence, items: int, taps: int, tb0: int) -> BinPlan:
    """The binned scatter's plan for ``maps`` maps of each ``(H, W)`` in
    ``sizes`` and ``items`` items of at most ``taps`` taps in all; bins
    start at top tap row ``tb0`` (-1 for K1-bwd, whose taps reach rows -1 ..
    H-1 from the top; 0 for K2-bwd, whose patch origins lie in 0 .. H-2).

    A warp sums one cell where the maps' cells get ``_BIN_RUN_TAPS`` taps or
    more on average (K1-bwd), else a run of 4 (K2-bwd); a cell of ``t`` taps
    on average is split among the largest power of two of warps, at most 8,
    that leaves each 32 taps or more. Bins are segments of
    ``sw`` columns, the same power of two for every size: the narrowest for
    which the counts (bins x chunks of 512 items, each zeroed, scanned and
    read) number at most 16 an item, where the cells kernel's warps read
    the fewest items they do not keep; a segment of a whole row where none
    does. Raises ``ValueError`` where an index exceeds an int32."""
    _check(items < 2 ** 31, f"binned scatter: {items} items, more than an int32 indexes")
    cells = sum(maps * H * W for H, W in sizes)
    ow = 1 if taps >= _BIN_RUN_TAPS * cells else 4
    per_warp = max(1, taps // (cells * _BIN_SLICE_TAPS)) if ow == 1 else 1
    split = 1 << (min(_BIN_MAX_SPLIT, per_warp).bit_length() - 1)
    chunks = -(-items // _BIN_CHUNK)
    rows = [H + 1 if tb0 == -1 else H - 1 for H, _ in sizes]

    def bins(sw):
        return sum(maps * rb * -(-W // sw) for rb, (_, W) in zip(rows, sizes))

    widest = 1 << (max(W for _, W in sizes) - 1).bit_length()
    sw = next((1 << k for k in range(widest.bit_length())
               if bins(1 << k) * chunks <= _BIN_COUNTS_PER_ITEM * items), widest)
    nbins = bins(sw)
    _check(nbins * chunks < 2 ** 31, f"binned scatter: {nbins} bins x {chunks} chunks of "
                                     f"counts, more than an int32 indexes")
    levels, bin0, warp0 = [], 0, 0
    for rb, (H, W) in zip(rows, sizes):
        nseg = -(-W // sw)
        levels.append(CellsPlan(sw, nseg, rb, tb0, bin0, warp0))
        bin0 += maps * rb * nseg
        warp0 += maps * H * -(-W // ow)
    return BinPlan(tuple(levels), nbins, items, chunks, ow, warp0, split)


def k1_bwd_plan(B: int, H: int, W: int, M: int) -> BinPlan:
    """K1-bwd's binned plan: ``B = bs*cams`` maps of ``H x W``, an item per
    (map, sample) of the ``M`` samples, 4 taps each."""
    return bin_plan(B, [(H, W)], B * M, 4 * B * M, tb0=-1)


def k2_bwd_plan(bs: int, cams: int, sizes: Sequence, M: int, n: int) -> BinPlan:
    """K2-bwd's binned plan: ``bs*cams`` maps of each fine level's ``(H,
    W)``, an item per (slot, level slot) of the ``bs*M`` slots' ``n`` level
    slots (every fine level, or ``level_k``), 4 taps each."""
    return bin_plan(bs * cams, sizes, bs * M * n, 4 * bs * M * n, tb0=0)


def bin_order(keys: torch.Tensor, nbins: int) -> tuple:
    """Plain version of the binned scatter's order (``bin_scan_kernel`` and
    ``bin_place_kernel``): ``keys [items]`` int32, each item's bin or -1 for
    an item that adds nothing -> (``order``, int64: the live items by bin
    and, within a bin, in their own order, as a stable sort leaves them;
    ``start [nbins + 1]`` int32: where each bin's run begins in ``order``,
    the last entry their count)."""
    live = torch.nonzero(keys >= 0).flatten()
    order = live[torch.sort(keys[live], stable=True).indices]
    counts = torch.bincount(keys[live].long(), minlength=nbins)
    start = torch.zeros(nbins + 1, dtype=torch.int32)
    start[1:] = torch.cumsum(counts, 0)
    return order, start


def k1_bin_keys(px, py, wg, H: int, W: int, plan: BinPlan) -> torch.Tensor:
    """Plain version of K1-bwd's keys (its sample blocks): px, py ``[B, M]``
    pixel coordinates, wg ``[B, M, G]`` -> ``[B*M]`` int32, the bin of each
    (map, sample) whose taps can reach the map with a non-zero weight (map,
    top tap row floor(py), segment of the left tap column max(floor(px),
    0)), else -1."""
    B, M = px.shape
    sw, nseg = plan.levels[0].sw, plan.levels[0].nseg
    live = (wg != 0).any(-1) & (px > -1) & (px < W) & (py > -1) & (py < H)
    tb = torch.floor(py).clamp(-1, H - 1).long() + 1
    col = torch.floor(px).clamp(0, W - 1).long()
    bc = torch.arange(B)[:, None]
    key = ((bc * (H + 1) + tb) * nseg + col // sw).to(torch.int32)
    return torch.where(live, key, torch.full_like(key, -1)).reshape(-1)


def k2_bin_keys(cam, x, y, cams: int, sizes: Sequence, plan: BinPlan, lvl=None) -> torch.Tensor:
    """Plain version of K2-bwd's keys (its row kernel): cam, x, y ``[bs, M]``
    over ``cams`` cameras, the fine levels' ``(H, W)`` and, for the level-k
    variant, lvl ``[bs, M, level_k]`` -> ``[bs*M*n]`` int32, the bin of each
    (slot, level slot) with a valid camera and level and a tap of non-zero
    hat weight (level, map, patch row sy, segment of the patch column sx),
    else -1."""
    bs, M = x.shape
    n = lvl.shape[2] if lvl is not None else len(sizes)
    keys = torch.full((bs, M, n), -1, dtype=torch.int32)
    maps = torch.arange(bs)[:, None] * cams + cam.long()
    for jl in range(n):
        level = lvl[..., jl].long() if lvl is not None else torch.full((bs, M), jl)
        for l, ((H, W), t) in enumerate(zip(sizes, plan.levels)):
            p, q = x * float(W) - 0.5, y * float(H) - 0.5
            sx, sy = torch.floor(p).clamp(0, W - 2), torch.floor(q).clamp(0, H - 2)
            weighs = torch.zeros_like(cam, dtype=torch.bool)
            for i in (0, 1):
                for j in (0, 1):
                    wxy = (1 - (q - (sy + i)).abs()).clamp(min=0) * \
                        (1 - (p - (sx + j)).abs()).clamp(min=0)
                    weighs |= wxy != 0
            key = t.bin0 + ((maps * (H - 1) + sy.long()) * t.nseg + sx.long() // t.sw)
            ok = (level == l) & weighs & (cam >= 0) & (cam < cams)
            keys[..., jl] = torch.where(ok, key.to(torch.int32), keys[..., jl])
    return keys.reshape(-1)


def _bin_scratch(plan: BinPlan, dev) -> tuple:
    """One allocation for a binned scatter, cut 16-byte aligned into
    ``hipad::BinScratch``'s keys, items, counts, totals, placed items and
    starts -> (the buffer, then their six addresses)."""
    sizes = (4 * plan.items, _BIN_ITEM_BYTES * plan.items, 4 * plan.nbins * plan.chunks,
             4 * plan.nbins, _BIN_ITEM_BYTES * plan.items, 4 * (plan.nbins + 1))
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 16) * 16
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    return (buf, *(buf.data_ptr() + o for o in offs))


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float  # 0.0 when an up-to-date build was reused
    log: str  # nvcc/ptxas output of the build (registers, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the sampler kernels are built with the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (if any source is newer than the library) and load the kernels.
    Processes that start together (the ranks of a data-parallel run) take a
    file lock in the build directory in turn: the first builds, the others
    find the library up to date."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        seconds, log = _build()
        lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    return _bind(lib, seconds, log)


def _build() -> tuple:
    """Compile and link the sources if the library is missing or older than
    one of them -> (seconds, nvcc's log); (0.0, "") when it is up to date."""
    out = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in _sources())
    seconds, log = 0.0, ""
    if not out.exists() or out.stat().st_mtime < newest:
        nvcc, pid = _nvcc(), os.getpid()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f".{src.stem}.{pid}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        tmp = BUILD_DIR / f".{LIB_NAME}.{pid}"
        link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log += text
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{text}")
        res = subprocess.run(link, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"kernel link failed ({' '.join(link)}):\n{log}")
        os.replace(tmp, out)
        for obj in objs:
            obj.unlink()
    return seconds, log


def _bind(lib: ctypes.CDLL, seconds: float, log: str) -> Library:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hipad_coarse_sample.argtypes = [p] * 4 + [i] * 14 + [p] * 3 + [i, p] + [i] * 6 + [p]
    lib.hipad_coarse_sample.restype = i
    lib.hipad_patch_sample.argtypes = [p] * 4 + [i] * 10 + [p] * 5 + [i, p] + [i] * 6 + [p]
    lib.hipad_patch_sample.restype = i
    lib.hipad_interp_sample_camsum_bwd.argtypes = [p, i] + [p] * 8 + [i] * 7 + [p] * 8
    lib.hipad_interp_sample_camsum_bwd.restype = i
    lib.hipad_patch_sample_bwd.argtypes = ([p] * 8 + [i] * 10 + [p] * 5 + [i] + [p] * 4
                                           + [i] * 6 + [p] * 8)
    lib.hipad_patch_sample_bwd.restype = i
    lib.hipad_row_gather.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.hipad_row_gather.restype = i
    lib.hipad_lsa_assign.argtypes = [i] + [p] * 8 + [i] * 3 + [p]
    lib.hipad_lsa_assign.restype = i
    ll = ctypes.c_longlong
    lib.hipad_cam_select.argtypes = [p] + [ll] * 4 + [p, i] + [p] * 4 + [ll] * 2 + [i] * 10 + [p]
    lib.hipad_cam_select.restype = i
    lib.hipad_point_sum.argtypes = [p, p, i, ll, i, i, p]
    lib.hipad_point_sum.restype = i
    return Library(lib=lib, path=BUILD_DIR / LIB_NAME, build_seconds=seconds, log=log)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_tensor(name: str, t: torch.Tensor, device: torch.device, dtypes, kernel: str,
                  align: int = 16):
    _check(t.device == device, f"{kernel}: {name} is on {t.device}, expected {device}")
    _check(t.dtype in dtypes, f"{kernel}: {name} has dtype {t.dtype}, takes {dtypes}")
    _check(t.is_contiguous(), f"{kernel}: {name} must be contiguous")
    _check(t.data_ptr() % align == 0, f"{kernel}: {name} must be {align}-byte aligned")


def _check_channels(kernel: str, C: int, G: int):
    _check(C % G == 0 and (C // G) % _VEC == 0 and C <= _MAX_C,
           f"{kernel}: takes C <= {_MAX_C} with C/G a multiple of {_VEC}; "
           f"got C={C}, G={G}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_pairs(k: str, pairs: int, G: int):
    _check(pairs <= _MAX_PAIRS, f"{k}: takes at most {_MAX_PAIRS} pairs, one a lane; got {pairs}")
    _check(_forward_smem_bytes(pairs, G) <= _STATIC_SMEM,
           f"{k}: {pairs} pairs of {G} groups need {_forward_smem_bytes(pairs, G)} B of shared "
           f"memory a block, more than {_STATIC_SMEM}")


def _check_maps(k: str, maps, bs: int, cams: int, C: int, dev):
    """Each map ``[bs, cams, H, W, C]``, one dtype, fp32 or bf16."""
    for i, fm in enumerate(maps):
        _check(fm.dim() == 5 and fm.shape[0] == bs and fm.shape[1] == cams
               and fm.shape[-1] == C,
               f"{k}: level {i} must be [bs, cams, H, W, C], got {tuple(fm.shape)}")
        _check(fm.dtype == maps[0].dtype, f"{k}: the levels must share one dtype")
        _check_tensor(f"level {i}", fm, dev, (torch.float32, torch.bfloat16), k)


def _check_k1_bwd(k: str, fm, px, py, wg, bs: int, cams: int):
    """Validate K1-bwd's inputs -> (B, H, W, C, M, G)."""
    _check(fm.is_cuda, f"{k}: takes CUDA tensors, got {fm.device}")
    dev = fm.device
    _check(fm.dim() == 4 and fm.shape[0] == bs * cams,
           f"{k}: fm must be [bs*cams, H, W, C], got {tuple(fm.shape)}")
    B, H, W, C = fm.shape
    _check(px.shape == py.shape and px.dim() == 2 and px.shape[0] == B,
           f"{k}: px, py must be [bs*cams, M], got {tuple(px.shape)}, {tuple(py.shape)}")
    M = px.shape[1]
    _check(wg.dim() == 3 and wg.shape[:2] == (B, M),
           f"{k}: wg must be [bs*cams, M, G], got {tuple(wg.shape)}")
    G = wg.shape[2]
    _check_channels(k, C, G)
    _check_tensor("fm", fm, dev, (torch.float32, torch.bfloat16), k)
    for name, t in (("px", px), ("py", py), ("wg", wg)):
        _check_tensor(name, t, dev, (torch.float32,), k)
    return B, H, W, C, M, G


def _check_k2(k: str, fine_maps, cam, x, y, w, cam_k: int, lvl=None, takes_levels=False):
    """Validate K2's (or K2-bwd's) inputs, and ``lvl`` for their level-k
    variants (``takes_levels``) -> (bs, M0, cams, C, G, n): ``n`` level slots
    per sample (every fine level, or ``level_k``)."""
    _check(x.is_cuda, f"{k}: takes CUDA tensors, got {x.device}")
    dev = x.device
    nlev = len(fine_maps)
    _check(1 <= nlev <= _MAX_LEVELS, f"{k}: takes 1..{_MAX_LEVELS} fine levels, got {nlev}")
    _check(x.dim() == 2 and x.shape == y.shape == cam.shape,
           f"{k}: cam, x, y must be [bs, M], got {tuple(cam.shape)}, "
           f"{tuple(x.shape)}, {tuple(y.shape)}")
    bs, M = x.shape
    _check(cam_k >= 1 and M % cam_k == 0, f"{k}: M={M} is not a multiple of cam_k={cam_k}")
    _check((lvl is not None) == takes_levels,
           f"{k}: {'takes' if takes_levels else 'takes no'} lvl [bs, M, level_k] (the "
           f"level-k variant is its own wrapper)")
    n = nlev
    if lvl is not None:
        _check(lvl.dim() == 3 and lvl.shape[:2] == (bs, M) and lvl.shape[2] >= 1,
               f"{k}: lvl must be [bs, M, level_k], got {tuple(lvl.shape)}")
        _check_tensor("lvl", lvl, dev, (torch.int32,), k)
        n = lvl.shape[2]
    _check(w.dim() == 4 and w.shape[:3] == (bs, M, n),
           f"{k}: w must be [bs, M, {n}, G], got {tuple(w.shape)}")
    G = w.shape[3]
    cams, C = fine_maps[0].shape[1], fine_maps[0].shape[-1]
    _check_channels(k, C, G)
    _check_maps(k, fine_maps, bs, cams, C, dev)
    for i, fm in enumerate(fine_maps):
        _check(fm.shape[2] >= 2 and fm.shape[3] >= 2,
               f"{k}: level {i} needs H, W >= 2, got {tuple(fm.shape)}")
    _check_tensor("cam", cam, dev, (torch.int32,), k)
    for name, t in (("x", x), ("y", y), ("w", w)):
        _check_tensor(name, t, dev, (torch.float32,), k)
    return bs, M // cam_k, cams, C, G, n


def _level_args(fine_maps):
    pad = _MAX_LEVELS - len(fine_maps)
    return ([fm.shape[2] for fm in fine_maps] + [0] * pad,
            [fm.shape[3] for fm in fine_maps] + [0] * pad)


def _launched(k: str, err: int):
    if err != 0:
        raise RuntimeError(f"{k}: launch failed with CUDA error {err}")


class CoarseSample:
    """K1 (``csrc/interp_sample.cu``): every coarse level's bilinear samples
    summed over cameras and levels and added to ``acc``, in one launch;
    replaces ``hipad_tpu/ops/pallas_interp.py:interp_matmul_pallas`` with the
    camera sum of ``interp_matmul_camsum`` and the coarse-level loop of
    ``deformable_samples_topk_flat``. Plain version:
    ``ops/sampling.py:coarse_sample_plain``."""

    name = "coarse_sample"

    def __init__(self):
        self.launches = 0

    def __call__(self, acc, maps: Sequence[torch.Tensor], points: torch.Tensor,
               weights: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
        """acc ``[bs, M0, C]`` fp32 or None; maps: ``[bs, cams, H_l, W_l, C]``
        fp32|bf16 (one dtype), ``maps[i]`` at index ``levels[i]`` of the
        weights' level axis; points ``[bs, M0, cams, 2]`` fp32 normalised;
        weights ``[bs, M0, cams, L, G]`` fp32|bf16 -> ``[bs, M0, C]`` fp32."""
        k = "K1 coarse_sample"
        _check(points.is_cuda, f"{k}: takes CUDA tensors, got {points.device}")
        dev = points.device
        _check(points.dim() == 4 and points.shape[-1] == 2,
               f"{k}: points must be [bs, M0, cams, 2], got {tuple(points.shape)}")
        bs, M0, cams, _ = points.shape
        _check(weights.dim() == 5 and weights.shape[:3] == (bs, M0, cams),
               f"{k}: weights must be [bs, M0, cams, L, G], got {tuple(weights.shape)}")
        L, G = weights.shape[3:]
        nlev = len(maps)
        _check(1 <= nlev <= _MAX_LEVELS and len(levels) == nlev
               and all(0 <= l < L for l in levels),
               f"{k}: takes 1..{_MAX_LEVELS} maps, each with its level index in [0, {L}); "
               f"got {nlev} maps, levels {tuple(levels)}")
        C = maps[0].shape[-1]
        _check_channels(k, C, G)
        _check_pairs(k, nlev * cams, G)
        _check_maps(k, maps, bs, cams, C, dev)
        _check_tensor("points", points, dev, (torch.float32,), k)
        _check_tensor("weights", weights, dev, (torch.float32, torch.bfloat16), k)
        if acc is not None:
            _check(acc.shape == (bs, M0, C),
                   f"{k}: acc must be [bs, M0, C], got {tuple(acc.shape)}")
            _check_tensor("acc", acc, dev, (torch.float32,), k)
        out = torch.empty(bs, M0, C, dtype=torch.float32, device=dev)
        pad = [0] * (_MAX_LEVELS - nlev)
        hs, ws = _level_args(maps)
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_coarse_sample(
                *[fm.data_ptr() for fm in maps], *pad, *hs, *ws, *levels, *pad, nlev,
                int(maps[0].dtype == torch.bfloat16), None if acc is None else acc.data_ptr(),
                points.data_ptr(), weights.data_ptr(), int(weights.dtype == torch.bfloat16),
                out.data_ptr(), bs, M0, cams, L, C, G, _stream(dev))
        _launched(k, err)
        self.launches += 1
        return out


class InterpSampleCamsumBwd:
    """K1-bwd (``csrc/interp_sample_bwd.cu``): the adjoint of one coarse
    level of K1 (``ops/sampling.py:interp_matmul_camsum``), called once per
    level by K1's autograd Function; replaces
    ``hipad_tpu/ops/sampling.py:_interp_matmul_tpu_bwd``. Plain version:
    autograd through ``interp_matmul_camsum``. The sample blocks give d px,
    d py, d wg and bin each (sample, camera) by its map, top tap row and
    column segment; a stable counting sort orders the bins, and a warp per
    cell of :func:`k1_bwd_plan` adds the cell's taps in that order
    (``csrc/bin_scatter.cuh``): the same bits on every run."""

    name = "interp_sample_camsum_bwd"
    def __init__(self):
        self.launches = 0

    def __call__(self, fm, px, py, wg, gout: torch.Tensor, bs: int,
               cams: int):
        """One level's camera-major inputs (fm ``[bs*cams, H, W, C]`` fp32|bf16;
        px, py ``[bs*cams, M]`` fp32 pixel coordinates; wg ``[bs*cams, M, G]``
        fp32) and ``gout [bs, M, C]`` fp32, the gradient of the level's
        camera sum -> (d fm ``[bs*cams, H, W, C]`` in ``fm``'s dtype, summed in
        fp32 and rounded once; d px, d py ``[bs*cams, M]`` and d wg
        ``[bs*cams, M, G]`` fp32)."""
        k = "K1-bwd interp_sample_camsum_bwd"
        B, H, W, C, M, G = _check_k1_bwd(k, fm, px, py, wg, bs, cams)
        _check(gout.shape == (bs, M, C), f"{k}: gout must be [bs, M, C], got {tuple(gout.shape)}")
        _check_tensor("gout", gout, fm.device, (torch.float32,), k)
        dev = fm.device
        plan = k1_bwd_plan(B, H, W, M)
        dfm = torch.empty_like(fm)  # every element written by the cells kernel
        dpx = torch.empty(B, M, dtype=torch.float32, device=dev)
        dpy = torch.empty_like(dpx)
        dwg = torch.empty(B, M, G, dtype=torch.float32, device=dev)
        scratch = _bin_scratch(plan, dev)  # held until the launch is queued
        ints = plan.host_ints()
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_interp_sample_camsum_bwd(
                fm.data_ptr(), int(fm.dtype == torch.bfloat16), px.data_ptr(), py.data_ptr(),
                wg.data_ptr(), gout.data_ptr(), dfm.data_ptr(), dpx.data_ptr(), dpy.data_ptr(),
                dwg.data_ptr(), bs, cams, H, W, C, G, M, *scratch[1:],
                (ctypes.c_int * len(ints))(*ints), _stream(dev))
        _launched(k, err)
        self.launches += 1
        return dfm, dpx, dpy, dwg


class PatchSample:
    """K2 (``csrc/patch_sample.cu``): fine-level patch sampling of
    camera-compacted samples, summed over the kept cameras and the fine
    levels; replaces the ``patch_bilinear_w`` loop of
    ``hipad_tpu/ops/sampling.py:deformable_samples_topk_flat``.
    Plain version: ``ops/sampling.py:patch_sample_plain``.

    Two instances with their own launch counts: ``patch_sample`` reads
    every fine level of each sample, ``patch_sample_lk`` (the level-k
    variant, ``sampler_level_k``; replaces that function's combined-pyramid
    loop, ``sampling.py:791-830``) only the levels ``lvl`` names."""

    def __init__(self, name: str, takes_levels: bool):
        self.name, self.takes_levels = name, takes_levels
        self.launches = 0

    def __call__(self, fine_maps: Sequence[torch.Tensor], cam: torch.Tensor,
               x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               cam_k: int, lvl=None) -> torch.Tensor:
        """fine_maps: ``[bs, cams, H_l, W_l, C]`` fp32|bf16 (one dtype);
        cam ``[bs, M]`` int32; x, y ``[bs, M]`` fp32; w ``[bs, M, n, G]``
        fp32 with ``n`` the number of fine levels, or ``level_k`` for the
        level-k variant, which takes lvl ``[bs, M, level_k]`` int32 (indices
        into ``fine_maps``); ``M = M0*cam_k`` -> ``[bs, M0, C]`` fp32."""
        k = f"K2 {self.name}"
        bs, M0, cams, C, G, n = _check_k2(k, fine_maps, cam, x, y, w, cam_k, lvl,
                                          self.takes_levels)
        _check_pairs(k, cam_k * n, G)
        out = torch.empty(bs, M0, C, dtype=torch.float32, device=x.device)
        ptrs = [fm.data_ptr() for fm in fine_maps] + [0] * (_MAX_LEVELS - len(fine_maps))
        hs, ws = _level_args(fine_maps)
        lib = library().lib
        with torch.cuda.device(x.device):
            err = lib.hipad_patch_sample(
                *ptrs, *hs, *ws, len(fine_maps), int(fine_maps[0].dtype == torch.bfloat16),
                cam.data_ptr(), x.data_ptr(), y.data_ptr(), w.data_ptr(),
                None if lvl is None else lvl.data_ptr(), n, out.data_ptr(), bs, cams, C, G,
                M0, cam_k, _stream(x.device))
        _launched(k, err)
        self.launches += 1
        return out


class PatchSampleBwd:
    """K2-bwd (``csrc/patch_sample_bwd.cu``): the adjoint of K2 over every
    fine level and slot; replaces ``hipad_tpu/ops/sampling.py:
    _patch_bilinear_w_bwd`` with ``_dense_fmap_grad``. Plain version:
    autograd through ``ops/sampling.py:patch_sample_plain``. Two instances
    with their own launch counts, as :class:`PatchSample`:
    ``patch_sample_bwd`` and the level-k variant ``patch_sample_bwd_lk``.
    The row kernel gives d x, d y, d w and bins each (slot, level) by its
    map, patch row and column segment; a stable counting sort orders the
    bins, and a warp per run of cells of :func:`k2_bwd_plan` adds its cells'
    taps in that order and writes each cell once (``csrc/bin_scatter.cuh``):
    the same bits on every run."""

    def __init__(self, name: str, takes_levels: bool):
        self.name, self.takes_levels = name, takes_levels
        self.launches = 0

    def __call__(self, fine_maps: Sequence[torch.Tensor], cam, x, y, w,
               gout: torch.Tensor, cam_k: int, lvl=None):
        """K2's inputs and ``gout [bs, M0, C]`` fp32, the gradient of its
        output -> (per-level d maps in the maps' dtype, summed in fp32 and
        rounded once; d x, d y ``[bs, M]``, d w ``[bs, M, n, G]`` fp32)."""
        k = f"K2-bwd {self.name}"
        bs, M0, cams, C, G, n = _check_k2(k, fine_maps, cam, x, y, w, cam_k, lvl,
                                          self.takes_levels)
        _check(gout.shape == (bs, M0, C), f"{k}: gout must be [bs, M0, C], got {tuple(gout.shape)}")
        dev = x.device
        _check_tensor("gout", gout, dev, (torch.float32,), k)
        pad = [0] * (_MAX_LEVELS - len(fine_maps))
        hs, ws = _level_args(fine_maps)
        plan = k2_bwd_plan(bs, cams, list(zip(hs, ws))[:len(fine_maps)], x.shape[1], n)
        dx = torch.empty_like(x)
        dy = torch.empty_like(y)
        dw = torch.empty_like(w)
        dmaps = [torch.empty_like(fm) for fm in fine_maps]  # every element written
        scratch = _bin_scratch(plan, dev)  # held until the launch is queued
        ints = plan.host_ints()
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_patch_sample_bwd(
                *[fm.data_ptr() for fm in fine_maps], *pad, *[d.data_ptr() for d in dmaps], *pad,
                *hs, *ws, len(fine_maps), int(fine_maps[0].dtype == torch.bfloat16),
                cam.data_ptr(), x.data_ptr(), y.data_ptr(), w.data_ptr(),
                None if lvl is None else lvl.data_ptr(), n, gout.data_ptr(), dx.data_ptr(),
                dy.data_ptr(), dw.data_ptr(), bs, cams, C, G, M0, cam_k, *scratch[1:],
                (ctypes.c_int * len(ints))(*ints), _stream(dev))
        _launched(k, err)
        self.launches += 1
        return dmaps, dx, dy, dw


_GATHER_ROWS_PER_BLOCK = 4  # csrc/row_gather.cu: two warps a row, 256 threads a block


def row_gather_geometry(n_out: int) -> tuple:
    """P2-P4's launch for ``n_out`` output rows -> ``(rows a block,
    blocks)``: two warps a row, four rows a block, the last block ragged."""
    return _GATHER_ROWS_PER_BLOCK, -(-n_out // _GATHER_ROWS_PER_BLOCK)


class RowGather:
    """P2-P4 (``csrc/row_gather.cu``): ``out[i] = table[idx[stride * i]]``
    over whole rows; replaces one of the Pallas gather probes of
    ``tools/probe_pallas_gather.py``. One instance per probe, each with its
    table dtype, its stride and its own launch count; its grid comes from
    :func:`row_gather_geometry`. Plain version:
    ``ops/gather.py:gather_rows_plain``."""

    def __init__(self, name: str, probe: str, dtype: torch.dtype, stride: int):
        self.name, self.probe, self.dtype, self.stride = name, probe, dtype, stride
        self.launches = 0

    def __call__(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """table ``[N, row]`` of ``self.dtype`` (rows of a multiple of 16
        bytes); idx ``[M]`` int32 in ``[0, N)`` (not checked: that would need
        a sync) -> ``[ceil(M / stride), row]`` of the table's dtype."""
        k = f"{self.probe} {self.name}"
        _check(table.is_cuda, f"{k}: takes CUDA tensors, got {table.device}")
        dev = table.device
        _check_tensor("table", table, dev, (self.dtype,), k)
        _check_tensor("idx", idx, dev, (torch.int32,), k)
        _check(table.dim() == 2 and idx.dim() == 1,
               f"{k}: table must be [N, row] and idx [M], got {tuple(table.shape)}, "
               f"{tuple(idx.shape)}")
        row = table.shape[1]
        row_bytes = row * table.element_size()
        _check(row_bytes % 16 == 0, f"{k}: rows of {row_bytes} bytes, need a multiple of 16")
        n_out = -(-idx.shape[0] // self.stride)
        out = torch.empty(n_out, row, dtype=table.dtype, device=dev)
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_row_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                       n_out, self.stride, row_bytes,
                                       row_gather_geometry(n_out)[1], _stream(dev))
        _launched(k, err)
        self.launches += 1
        return out


# K3 (csrc/lsa_assign.cu): columns a thread in registers, threads a block at
# most, the problems one launch takes, and the shared memory ahead of the
# state (kSlotBytes: two buffers of 32 warps' 8-byte key and 4-byte column)
_LSA_COLS = (1, 2)
_LSA_MAX_THREADS = 1024
_LSA_MAX_PROBLEMS = 8
_LSA_SLOT_BYTES = 2 * 32 * 12


class LsaPlan(NamedTuple):
    """K3's block for one ``[R, C]`` matrix (``N = C + R + 1`` padded
    columns): ``cols`` columns a thread in registers (1 or 2), or 0 for the
    strip kernel, which keeps every column's state in memory; ``threads`` a
    block; ``staged``: the costs in shared memory; ``smem`` bytes of
    dynamic shared memory a block; ``scratch`` bytes of global memory a
    matrix for the strip kernel's state where it does not fit shared memory
    (0 where it does)."""

    cols: int
    threads: int
    staged: bool
    smem: int
    scratch: int


def lsa_plan(R: int, C: int) -> LsaPlan:
    """K3's block for one ``[R, C]`` matrix. Up to 2,048 padded columns a
    thread holds 1 or 2 columns in registers (the fewest that ``N`` fits at
    1024 threads), ``threads`` a multiple of 32, and the shared memory holds
    the state (``u`` and the row mask per row, ``p`` and ``way`` per column,
    the reduction slots) plus ``R*C*4`` bytes of costs where that fits the
    232,448 a block may take; else the kernel reads the costs from global
    memory. Above that the strip kernel takes the matrix at 1024 threads,
    the costs in global memory and the state (``u`` and the row mask per
    row; ``v``, ``minv``, ``p``, ``way`` and ``used`` per column) in shared
    memory where it fits, else in ``scratch`` bytes of global memory."""
    N = C + R + 1
    fits = [c for c in _LSA_COLS if N <= c * _LSA_MAX_THREADS]
    if not fits:
        state = (9 * R + 25 * N + 15) // 16 * 16
        if _LSA_SLOT_BYTES + state <= _SMEM_PER_BLOCK:
            return LsaPlan(0, _LSA_MAX_THREADS, False, _LSA_SLOT_BYTES + state, 0)
        return LsaPlan(0, _LSA_MAX_THREADS, False, _LSA_SLOT_BYTES, state)
    cols = fits[0]
    threads = -(-N // (32 * cols)) * 32
    state = (_LSA_SLOT_BYTES + 8 * R + 8 * N + R + 15) // 16 * 16
    staged = state + 4 * R * C <= _SMEM_PER_BLOCK
    return LsaPlan(cols, threads, staged, state + 4 * R * C if staged else state, 0)


def lsa_launches(plans: Sequence[LsaPlan]) -> list:
    """K3's launches for problems with ``plans`` -> lists of the problems'
    indices, one list a launch: the register kernel's problems and the strip
    kernel's apart, each in the callers' order, at most 8 a launch; the
    launches in the order of their first problem."""
    kinds = {}
    for i, plan in enumerate(plans):
        kinds.setdefault(plan.cols == 0, []).append(i)
    return sorted((idx[a:a + _LSA_MAX_PROBLEMS] for idx in kinds.values()
                   for a in range(0, len(idx), _LSA_MAX_PROBLEMS)), key=lambda g: g[0])


class LsaAssign:
    """K3 (``csrc/lsa_assign.cu``): the exact assignment of every ``[R, C]``
    cost matrix of any number of problems, one block per matrix
    (:func:`lsa_plan` sizes each block), up to 8 problems a launch
    (:func:`lsa_launches`); replaces
    ``hipad_tpu/targets/matching.py:_lsa_single`` with ``assign``. Plain
    version: ``targets/matching.py:assign_plain``, equal bit for bit."""

    name = "lsa_assign"

    def __init__(self):
        self.launches = 0

    def __call__(self, problems: Sequence) -> list:
        """``(cost [n, R, C] fp32, row_mask [n, R] bool)`` pairs, contiguous,
        on one card -> col4row ``[n, R]`` int32 of each, in the callers'
        order, on the card: the column of each row, -1 for an invalid row
        and for a row left without a real column (more valid rows than
        columns). One launch for up to 8 problems of one kernel (none where
        every problem is empty); nothing waits for the host."""
        k = "K3 lsa_assign"
        _check(len(problems) > 0, f"{k}: takes 1 or more problems, got none")
        _check(problems[0][0].is_cuda, f"{k}: takes CUDA tensors, got {problems[0][0].device}")
        dev = problems[0][0].device
        outs, todo = [], []
        for cost, row_mask in problems:
            _check(cost.dim() == 3 and row_mask.shape == cost.shape[:2],
                   f"{k}: cost must be [n, R, C] and row_mask [n, R], got "
                   f"{tuple(cost.shape)}, {tuple(row_mask.shape)}")
            _check_tensor("cost", cost, dev, (torch.float32,), k, align=4)
            _check_tensor("row_mask", row_mask, dev, (torch.bool,), k, align=1)
            n, R, C = cost.shape
            out = torch.empty(n, R, dtype=torch.int32, device=dev)
            outs.append(out)
            if n * R:
                todo.append((cost, row_mask, out, lsa_plan(R, C)))
        lib = library().lib
        for group in lsa_launches([t[3] for t in todo]):
            batch = [todo[i] for i in group]
            plans = [t[3] for t in batch]
            cols = max(plan.cols for plan in plans)
            threads = max(-(-(c.shape[1] + c.shape[2] + 1) // (32 * cols)) * 32
                          for c, *_ in batch) if cols else _LSA_MAX_THREADS
            smem = max(plan.smem for plan in plans)
            # the strip kernel's state where shared memory does not hold it
            scratch = [torch.empty(t[0].shape[0] * t[3].scratch, dtype=torch.uint8, device=dev)
                       if t[3].scratch else None for t in batch]
            q = len(batch)
            ptrs = [(ctypes.c_void_p * q)(*(t[i].data_ptr() for t in batch)) for i in range(3)]
            ptrs.append((ctypes.c_void_p * q)(*(None if b is None else b.data_ptr()
                                                for b in scratch)))
            ints = [(ctypes.c_int * q)(*v) for v in (
                [t[0].shape[0] for t in batch], [t[0].shape[1] for t in batch],
                [t[0].shape[2] for t in batch], [int(plan.staged) for plan in plans])]
            with torch.cuda.device(dev):
                err = lib.hipad_lsa_assign(q, *ptrs, *ints, cols, threads, smem, _stream(dev))
            _launched(k, err)
            self.launches += 1
        return outs


_MAX_CAMS = 8  # csrc/cam_select.cu: kMaxCams


class CamSelect:
    """The camera selection (``csrc/cam_select.cu``): each flat sample's
    ``cam_k`` cameras ranked by in-bounds-ness, their points, and their fine
    levels' weights times the inside mask, renormalised to the full
    in-bounds mass where asked, in one launch: what K2 takes. Replaces the
    camera ``topk_by_argmax`` with its gathers and renormalisation of
    ``hipad_tpu/ops/sampling.py:745-780``. Plain version:
    ``ops/sampling.py:select_cameras_plain``: cam, x, y equal, the weights
    too but for the renormalisation's sums, which add in camera order."""

    name = "cam_select"

    def __init__(self):
        self.launches = 0

    def __call__(self, points: torch.Tensor, weights: torch.Tensor, cam_k: int,
                 cam_renorm: bool, fine: Sequence[int]):
        """points ``[bs, M0, cams, 2]`` fp32, any strides (the model's view
        is read as it lies); weights ``[bs, M0, cams, L, G]`` fp32|bf16,
        contiguous; ``cam_k <= cams <= 8``; ``fine``, 1-4 indices of the
        weights' level axis -> (cam ``[bs, M]`` int32, x, y ``[bs, M]`` fp32,
        w_fine ``[bs, M, len(fine), G]`` fp32), ``M = M0*cam_k``, the slot
        index fastest; with ``cam_renorm`` and ``cam_k < cams`` the kept
        weights carry the renormalisation."""
        k = "cam_select"
        _check(points.is_cuda, f"{k}: takes CUDA tensors, got {points.device}")
        dev = points.device
        _check(points.dim() == 4 and points.shape[-1] == 2,
               f"{k}: points must be [bs, M0, cams, 2], got {tuple(points.shape)}")
        bs, M0, cams, _ = points.shape
        _check(weights.dim() == 5 and weights.shape[:3] == (bs, M0, cams),
               f"{k}: weights must be [bs, M0, cams, L, G], got {tuple(weights.shape)}")
        L, G = weights.shape[3:]
        _check(1 <= cams <= _MAX_CAMS and 1 <= cam_k <= cams and G >= 1,
               f"{k}: takes 1 <= cam_k <= cams <= {_MAX_CAMS}; got cam_k={cam_k}, cams={cams}")
        fine = tuple(fine)
        _check(1 <= len(fine) <= _MAX_LEVELS and all(0 <= l < L for l in fine),
               f"{k}: takes 1..{_MAX_LEVELS} fine levels in [0, {L}), got {fine}")
        _check(bs * M0 * len(fine) * G < 2 ** 31,
               f"{k}: {bs * M0} samples x {len(fine)} levels x {G} groups, a thread each, "
               f"more than an int32 indexes")
        _check(points.device == dev and points.dtype == torch.float32,
               f"{k}: points must be fp32 on {dev}, got {points.dtype} on {points.device}")
        _check_tensor("weights", weights, dev, (torch.float32, torch.bfloat16), k,
                      align=weights.element_size())
        M = M0 * cam_k
        cam = torch.empty(bs, M, dtype=torch.int32, device=dev)
        x = torch.empty(bs, M, dtype=torch.float32, device=dev)
        y = torch.empty_like(x)
        w = torch.empty(bs, M, len(fine), G, dtype=torch.float32, device=dev)
        f = list(fine) + [0] * (_MAX_LEVELS - len(fine))
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_cam_select(
                points.data_ptr(), *points.stride(), weights.data_ptr(),
                int(weights.dtype == torch.bfloat16), cam.data_ptr(), x.data_ptr(), y.data_ptr(),
                w.data_ptr(), bs, M0, cams, L, G, *f, len(fine), cam_k, int(bool(cam_renorm)),
                _stream(dev))
        _launched(k, err)
        self.launches += 1
        return cam, x, y, w


class PointSum:
    """The point sum (``csrc/point_sum.cu``): the sampler's flat samples
    rounded to the weights' dtype and each anchor's points summed in fp32
    in one fixed order (16 chains, then the chains in order), rounded once.
    Replaces ``flat.reshape(bs, anchors, P, C).sum(axis=2)`` of
    ``hipad_tpu/ops/sampling.py:990``. Plain version:
    ``ops/sampling.py:point_sum_plain``, which adds in torch's order."""

    name = "point_sum"

    def __init__(self):
        self.launches = 0

    def __call__(self, flat: torch.Tensor, num_pts: int, dtype: torch.dtype) -> torch.Tensor:
        """flat ``[bs, anchors*num_pts, C]`` fp32, the anchor's points
        consecutive; ``dtype`` fp32|bf16 -> ``[bs, anchors, C]`` of
        ``dtype``."""
        k = "point_sum"
        _check(flat.is_cuda, f"{k}: takes CUDA tensors, got {flat.device}")
        dev = flat.device
        _check(flat.dim() == 3, f"{k}: flat must be [bs, M0, C], got {tuple(flat.shape)}")
        bs, M0, C = flat.shape
        _check(num_pts >= 1 and M0 % num_pts == 0,
               f"{k}: M0={M0} is not a multiple of num_pts={num_pts} >= 1")
        _check(dtype in (torch.float32, torch.bfloat16),
               f"{k}: writes fp32 or bf16, asked for {dtype}")
        _check(C % 4 == 0, f"{k}: reads 4 channels a lane, takes C % 4 == 0; got C={C}")
        _check_tensor("flat", flat, dev, (torch.float32,), k)
        out = torch.empty(bs, M0 // num_pts, C, dtype=dtype, device=dev)
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_point_sum(flat.data_ptr(), out.data_ptr(),
                                      int(dtype == torch.bfloat16), bs * (M0 // num_pts),
                                      num_pts, C, _stream(dev))
        _launched(k, err)
        self.launches += 1
        return out


coarse_sample = CoarseSample()
interp_sample_camsum_bwd = InterpSampleCamsumBwd()
patch_sample = PatchSample("patch_sample", takes_levels=False)
patch_sample_bwd = PatchSampleBwd("patch_sample_bwd", takes_levels=False)
patch_sample_lk = PatchSample("patch_sample_lk", takes_levels=True)
patch_sample_bwd_lk = PatchSampleBwd("patch_sample_bwd_lk", takes_levels=True)
gather_rows_f32 = RowGather("gather_rows_f32", "P2", torch.float32, 1)
gather_rows_bf16 = RowGather("gather_rows_bf16", "P3", torch.bfloat16, 1)
gather_rows_f32_every8 = RowGather("gather_rows_f32_every8", "P4", torch.float32, 8)
lsa_assign = LsaAssign()
cam_select = CamSelect()
point_sum = PointSum()
WRAPPERS = (coarse_sample, patch_sample, interp_sample_camsum_bwd, patch_sample_bwd,
            gather_rows_f32, gather_rows_bf16, gather_rows_f32_every8, patch_sample_lk,
            patch_sample_bwd_lk, lsa_assign, cam_select, point_sum)
# every kernel's launch count: one a wrapper
KERNELS = WRAPPERS
