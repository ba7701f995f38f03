"""Build, bind and launch the port's CUDA kernels: the sampler's K1 (every
coarse level in one launch) and K2 (the fine levels) forward, K1-bwd and
K2-bwd for their gradients, K2's and K2-bwd's level-k variants (each sample
reads only its kept fine levels: ``sampler_level_k``), the row gather
that stands in for the Pallas gather probes P2-P4, and K3, the training
step's batched assignment solver.

The sources ``hipad_torch/csrc/*.cu`` are compiled with plain ``nvcc`` for
``sm_90a``, one ``nvcc`` per source and all started together, then linked
into one shared library with a C interface, on first use, into
``build/hipad_torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``. Nothing here runs at import time: the CPU tests import this
module on hosts without a card or a compiler.

Each wrapper checks device, dtype, shape, contiguity and alignment, raises
on anything its kernel does not take, allocates its outputs (``torch.empty``;
``torch.zeros`` for the map gradients an atomic route adds into), launches on
PyTorch's current stream and raises if the launch reports a CUDA error.
Each keeps ``launches``, the number of calls that launched its kernel, so a
run can show that the main path went through the kernel.

Each wrapper also declares its ``routes`` (:class:`Route`): the designs it
can launch, and whether each adds with float atomics into an output that
several threads share, which makes the sum's rounding change from run to
run. A call takes ``route()``: with torch's deterministic flag on
(``torch.use_deterministic_algorithms(True)``) the first route that adds
no atomics, else the first route; under the flag a wrapper with no such
route raises, naming its kernel, as torch's own nondeterministic CUDA ops
do (:func:`pick_route`).
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

# K1-bwd's tile blocks (csrc/interp_sample_bwd.cu) on an H100 SXM: 132 SMs,
# 227 KB of shared memory a block can have, 228 KB an SM shares among its
# blocks (each also holding 1 KB for the system). Registers allow two blocks
# of 512 threads an SM (__launch_bounds__(kTileThreads, 2)).
_SMS = 132
_SMEM_PER_BLOCK = 232_448
_SMEM_PER_SM = 233_472
_SMEM_RESERVED = 1024
_TILE_BLOCKS_PER_SM = 2
_TILE_CHANNELS = (32, 16, 8)  # one lane each, the widest that fits first
_MAX_CLUSTER = 8  # the portable cluster size


def k1_bwd_tiling(B: int, H: int, W: int, C: int, G: int) -> tuple:
    """The tiles of K1-bwd's map gradient for ``B = bs*cams`` maps of
    ``H x W`` cells and ``C`` channels in ``G`` groups -> ``(Ct, S, smem)``:
    ``Ct`` channels of one group per tile, ``S`` blocks per tile in one
    cluster, ``smem`` the bytes of each block's fp32 copy of its tile.

    A map whose whole ``H*W*Ct`` tile fits one block's shared memory at 32,
    16 or 8 channels takes the widest such ``Ct`` and one tile per channel
    slice. A larger map (more than 7,264 cells) takes the widest ``Ct`` and
    is cut into bands of ``Hb`` whole rows, as few as fit and of equal height
    but the last: ``smem = Hb*W*Ct*4``, from which the kernel reads ``Hb``.
    ``S`` is the largest power of two, at most 8, for which the clusters of
    every tile fill the SMs at most once: such clusters pack into the card's
    GPCs without gaps, and on an H100 clusters of 4 beat those of 3, 5 and 8
    at stage 2's coarse levels (PERF.md). Raises ``ValueError`` when one row
    does not fit at 8 channels (more than 7,264 cells in a row)."""
    gd = C // G
    widths = [ct for ct in _TILE_CHANNELS if gd % ct == 0]
    _check(bool(widths), f"K1-bwd: C/G = {gd} is not a multiple of {_TILE_CHANNELS[-1]}")
    whole = [ct for ct in widths if H * W * ct * 4 <= _SMEM_PER_BLOCK]
    if whole:
        ct, hb = whole[0], H
    else:
        rows = [ct for ct in widths if W * ct * 4 <= _SMEM_PER_BLOCK]
        _check(bool(rows), f"K1-bwd: a row of {W} cells does not fit a block's "
                           f"{_SMEM_PER_BLOCK} B of shared memory at {widths[-1]} channels "
                           f"per tile (C/G = {gd})")
        ct = rows[0]
        bands = -(-H // (_SMEM_PER_BLOCK // (W * ct * 4)))
        hb = -(-H // bands)
    smem = hb * W * ct * 4
    tiles = B * (C // ct) * -(-H // hb)
    per_sm = min(_SMEM_PER_SM // (smem + _SMEM_RESERVED), _TILE_BLOCKS_PER_SM)
    s = max(1, min(_MAX_CLUSTER, _SMS * per_sm // tiles))
    return ct, 1 << (s.bit_length() - 1), smem


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
    lib.hipad_interp_sample_camsum_bwd.argtypes = [p, i] + [p] * 8 + [i] * 11 + [p]
    lib.hipad_interp_sample_camsum_bwd.restype = i
    lib.hipad_patch_sample_bwd.argtypes = ([p] * 8 + [i] * 10 + [p] * 5 + [i] + [p] * 5
                                           + [i] * 6 + [p])
    lib.hipad_patch_sample_bwd.restype = i
    lib.hipad_patch_sample_bwd_cells.argtypes = ([p] * 4 + [i] * 10 + [p] * 5 + [i, p]
                                                 + [i] * 6 + [p])
    lib.hipad_patch_sample_bwd_cells.restype = i
    lib.hipad_row_gather.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.hipad_row_gather.restype = i
    lib.hipad_lsa_assign.argtypes = [i] + [p] * 8 + [i] * 3 + [p]
    lib.hipad_lsa_assign.restype = i
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


@dataclasses.dataclass(frozen=True)
class Route:
    """One design a wrapper can launch: ``name``, and ``atomic``: whether it
    adds with float atomics into an output that several threads share (the
    sum's rounding then changes from run to run)."""

    name: str
    atomic: bool


def pick_route(kernel: str, routes: Sequence[Route], deterministic: bool) -> Route:
    """The route a call takes: under torch's deterministic flag the first of
    ``routes`` that adds no atomics, else the first. Raises RuntimeError,
    naming ``kernel``, under the flag when every route adds with atomics."""
    if not deterministic:
        return routes[0]
    for r in routes:
        if not r.atomic:
            return r
    raise RuntimeError(f"{kernel} does not have a deterministic implementation, but you set "
                       f"'torch.use_deterministic_algorithms(True)'")


class Launches:
    """The launch count of a wrapper's second route, a kernel of its own:
    ``name`` is the wrapper's and the route's."""

    def __init__(self, name: str):
        self.name, self.launches = name, 0


class _Routed:
    """A wrapper: ``routes``, the first taken without the flag; a call
    launches ``launch(self.route(), ...)``. Launches of the first route count
    in ``launches``, those of another in ``others[route.name].launches``."""

    routes: tuple = (Route("one launch", atomic=False),)

    def route(self) -> Route:
        return pick_route(self.name, self.routes, torch.are_deterministic_algorithms_enabled())

    def __call__(self, *args, **kwargs):
        return self.launch(self.route(), *args, **kwargs)

    @functools.cached_property
    def others(self) -> dict:
        return {r.name: Launches(f"{self.name}_{r.name}") for r in self.routes[1:]}

    def _count(self, route: Route):
        if route == self.routes[0]:
            self.launches += 1
        else:
            self.others[route.name].launches += 1


class CoarseSample(_Routed):
    """K1 (``csrc/interp_sample.cu``): every coarse level's bilinear samples
    summed over cameras and levels and added to ``acc``, in one launch;
    replaces ``hipad_tpu/ops/pallas_interp.py:interp_matmul_pallas`` with the
    camera sum of ``interp_matmul_camsum`` and the coarse-level loop of
    ``deformable_samples_topk_flat``. Plain version:
    ``ops/sampling.py:coarse_sample_plain``."""

    name = "coarse_sample"

    def __init__(self):
        self.launches = 0

    def launch(self, route: Route, acc, maps: Sequence[torch.Tensor], points: torch.Tensor,
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
        self._count(route)
        return out


class InterpSampleCamsumBwd(_Routed):
    """K1-bwd (``csrc/interp_sample_bwd.cu``): the adjoint of one coarse
    level of K1 (``ops/sampling.py:interp_matmul_camsum``), called once per
    level by K1's autograd Function; replaces
    ``hipad_tpu/ops/sampling.py:_interp_matmul_tpu_bwd``. Plain version:
    autograd through ``interp_matmul_camsum``. One call makes two launches:
    the sample blocks (d px, d py, d wg) and the tile blocks (d fm, tiled by
    :func:`k1_bwd_tiling`, in bands of rows for maps of more than 7,264
    cells). The tile blocks' routes: ``atomic`` (a block's warps split its
    samples and add by shared-memory atomics) and ``owned`` (each warp adds
    only into the cells it owns, in the samples' order: the same bits on
    every run)."""

    name = "interp_sample_camsum_bwd"
    ATOMIC = Route("atomic", atomic=True)
    OWNED = Route("owned", atomic=False)
    routes = (ATOMIC, OWNED)

    def __init__(self):
        self.launches = 0

    def launch(self, route: Route, fm, px, py, wg, gout: torch.Tensor, bs: int,
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
        ct, s, smem = k1_bwd_tiling(B, H, W, C, G)
        dev = fm.device
        dfm = torch.empty_like(fm)  # every element written by the tile blocks
        dpx = torch.empty(B, M, dtype=torch.float32, device=dev)
        dpy = torch.empty_like(dpx)
        dwg = torch.empty(B, M, G, dtype=torch.float32, device=dev)
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_interp_sample_camsum_bwd(
                fm.data_ptr(), int(fm.dtype == torch.bfloat16), px.data_ptr(),
                py.data_ptr(), wg.data_ptr(), gout.data_ptr(), dfm.data_ptr(),
                dpx.data_ptr(), dpy.data_ptr(), dwg.data_ptr(),
                bs, cams, H, W, C, G, M, ct, s, smem, int(not route.atomic), _stream(dev))
        _launched(k, err)
        self._count(route)
        return dfm, dpx, dpy, dwg


class PatchSample(_Routed):
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

    def launch(self, route: Route, fine_maps: Sequence[torch.Tensor], cam: torch.Tensor,
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
        self._count(route)
        return out


def contribution_index(keys: torch.Tensor, cells: int) -> tuple:
    """K2-bwd's deterministic route: ``keys [items]`` int32, the cell each
    item adds into (``cells`` for an item that adds nothing) -> (``order
    [items]`` int64, the items by cell and, within a cell, in their own
    order: a stable sort of the keys; ``starts [cells + 1]`` int32, where
    each cell's run begins in ``order``, the last entry where the items
    that add nothing begin)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    cell = torch.arange(cells + 1, dtype=keys.dtype, device=keys.device)
    return order, torch.searchsorted(sorted_keys, cell, out_int32=True)


class PatchSampleBwd(_Routed):
    """K2-bwd (``csrc/patch_sample_bwd.cu``): the adjoint of K2 over every
    fine level and slot; replaces ``hipad_tpu/ops/sampling.py:
    _patch_bilinear_w_bwd`` with ``_dense_fmap_grad``. Plain version:
    autograd through ``ops/sampling.py:patch_sample_plain``. Two instances
    with their own launch counts, as :class:`PatchSample`:
    ``patch_sample_bwd`` and the level-k variant ``patch_sample_bwd_lk``.

    Routes: ``atomic`` (one launch, the map gradient added by 16-byte fp32
    reductions into zeroed buffers) and ``pull`` (the row kernel writes each
    item's cell, :func:`contribution_index` orders the items by cell, and
    the cell kernel sums each cell's items in that order and writes it
    once: the same bits on every run)."""

    ATOMIC = Route("atomic", atomic=True)
    PULL = Route("pull", atomic=False)
    routes = (ATOMIC, PULL)

    def __init__(self, name: str, takes_levels: bool):
        self.name, self.takes_levels = name, takes_levels
        self.launches = 0

    def launch(self, route: Route, fine_maps: Sequence[torch.Tensor], cam, x, y, w,
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
        cells = sum(fm.shape[0] * fm.shape[1] * fm.shape[2] * fm.shape[3] for fm in fine_maps)
        _check(cells < 2 ** 31 - 1 and x.numel() * n * 4 < 2 ** 31,
               f"{k}: {cells} map cells and {x.numel() * n * 4} taps, more than an int32 indexes")
        dx = torch.empty_like(x)
        dy = torch.empty_like(y)
        dw = torch.empty_like(w)
        pad = [0] * (_MAX_LEVELS - len(fine_maps))
        hs, ws = _level_args(fine_maps)
        bf16 = int(fine_maps[0].dtype == torch.bfloat16)
        lib = library().lib
        if route.atomic:
            dmaps = [torch.zeros(fm.shape, dtype=torch.float32, device=dev) for fm in fine_maps]
            keys = None
        else:
            dmaps = [torch.empty_like(fm) for fm in fine_maps]  # every element written
            keys = torch.empty(x.numel() * n * 4, dtype=torch.int32, device=dev)
        for i, d in enumerate(dmaps):  # 16-byte accesses
            _check_tensor(f"d level {i}", d, dev, (d.dtype,), k)
        with torch.cuda.device(dev):
            err = lib.hipad_patch_sample_bwd(
                *[fm.data_ptr() for fm in fine_maps], *pad,
                *([d.data_ptr() for d in dmaps] if route.atomic else [0] * len(dmaps)), *pad,
                *hs, *ws, len(fine_maps), bf16, cam.data_ptr(), x.data_ptr(), y.data_ptr(),
                w.data_ptr(), None if lvl is None else lvl.data_ptr(), n, gout.data_ptr(),
                dx.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                None if keys is None else keys.data_ptr(), bs, cams, C, G, M0, cam_k,
                _stream(dev))
            _launched(k, err)
            if keys is not None:
                order, starts = contribution_index(keys, cells)
                err = lib.hipad_patch_sample_bwd_cells(
                    *[d.data_ptr() for d in dmaps], *pad, *hs, *ws, len(fine_maps), bf16,
                    starts.data_ptr(), order.data_ptr(), x.data_ptr(), y.data_ptr(),
                    w.data_ptr(), n, gout.data_ptr(), bs, cams, C, G, M0, cam_k,
                    _stream(dev))
                _launched(k, err)
        self._count(route)
        return [d.to(fm.dtype) for d, fm in zip(dmaps, fine_maps)], dx, dy, dw


_GATHER_ROWS_PER_BLOCK = 4  # csrc/row_gather.cu: two warps a row, 256 threads a block


def row_gather_geometry(n_out: int) -> tuple:
    """P2-P4's launch for ``n_out`` output rows -> ``(rows a block,
    blocks)``: two warps a row, four rows a block, the last block ragged."""
    return _GATHER_ROWS_PER_BLOCK, -(-n_out // _GATHER_ROWS_PER_BLOCK)


class RowGather(_Routed):
    """P2-P4 (``csrc/row_gather.cu``): ``out[i] = table[idx[stride * i]]``
    over whole rows; replaces one of the Pallas gather probes of
    ``tools/probe_pallas_gather.py``. One instance per probe, each with its
    table dtype, its stride and its own launch count; its grid comes from
    :func:`row_gather_geometry`. Plain version:
    ``ops/gather.py:gather_rows_plain``."""

    def __init__(self, name: str, probe: str, dtype: torch.dtype, stride: int):
        self.name, self.probe, self.dtype, self.stride = name, probe, dtype, stride
        self.launches = 0

    def launch(self, route: Route, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
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
        self._count(route)
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


class LsaAssign(_Routed):
    """K3 (``csrc/lsa_assign.cu``): the exact assignment of every ``[R, C]``
    cost matrix of any number of problems, one block per matrix
    (:func:`lsa_plan` sizes each block), up to 8 problems a launch
    (:func:`lsa_launches`); replaces
    ``hipad_tpu/targets/matching.py:_lsa_single`` with ``assign``. Plain
    version: ``targets/matching.py:assign_plain``, equal bit for bit."""

    name = "lsa_assign"

    def __init__(self):
        self.launches = 0

    def launch(self, route: Route, problems: Sequence) -> list:
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
            self._count(route)
        return outs


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
WRAPPERS = (coarse_sample, patch_sample, interp_sample_camsum_bwd, patch_sample_bwd,
            gather_rows_f32, gather_rows_bf16, gather_rows_f32_every8, patch_sample_lk,
            patch_sample_bwd_lk, lsa_assign)
# every kernel's launch count: each wrapper's, and the deterministic routes
# that stand beside the backward wrappers' atomic ones
KERNELS = WRAPPERS + tuple(c for k in WRAPPERS for c in k.others.values())
