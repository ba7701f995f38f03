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
``torch.zeros`` for the map gradients K2-bwd adds into), launches on
PyTorch's current stream and raises if the launch reports a CUDA error.
Each keeps ``launches``, the number of launches it made, so a run can show
that the main path went through the kernel.
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
from typing import Sequence

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
    lib.hipad_interp_sample_camsum_bwd.argtypes = [p, i] + [p] * 8 + [i] * 10 + [p]
    lib.hipad_interp_sample_camsum_bwd.restype = i
    lib.hipad_patch_sample_bwd.argtypes = ([p] * 8 + [i] * 10 + [p] * 5 + [i] + [p] * 4
                                           + [i] * 6 + [p])
    lib.hipad_patch_sample_bwd.restype = i
    lib.hipad_row_gather.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.hipad_row_gather.restype = i
    lib.hipad_lsa_assign.argtypes = [p] * 3 + [i] * 3 + [p]
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
    autograd through ``interp_matmul_camsum``. One call makes two launches:
    the sample blocks (d px, d py, d wg) and the tile blocks (d fm, tiled by
    :func:`k1_bwd_tiling`, in bands of rows for maps of more than 7,264
    cells)."""

    name = "interp_sample_camsum_bwd"

    def __init__(self):
        self.launches = 0

    def __call__(self, fm, px, py, wg, gout: torch.Tensor, bs: int, cams: int):
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
                bs, cams, H, W, C, G, M, ct, s, smem, _stream(dev))
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
    fine level and slot in one launch; replaces ``hipad_tpu/ops/sampling.py:
    _patch_bilinear_w_bwd`` with ``_dense_fmap_grad``. Plain version:
    autograd through ``ops/sampling.py:patch_sample_plain``. Two instances
    with their own launch counts, as :class:`PatchSample`:
    ``patch_sample_bwd`` and the level-k variant ``patch_sample_bwd_lk``."""

    def __init__(self, name: str, takes_levels: bool):
        self.name, self.takes_levels = name, takes_levels
        self.launches = 0

    def __call__(self, fine_maps: Sequence[torch.Tensor], cam, x, y, w,
                 gout: torch.Tensor, cam_k: int, lvl=None):
        """K2's inputs and ``gout [bs, M0, C]`` fp32, the gradient of its
        output -> (per-level d maps fp32, d x, d y ``[bs, M]``, d w
        ``[bs, M, n, G]``)."""
        k = f"K2-bwd {self.name}"
        bs, M0, cams, C, G, n = _check_k2(k, fine_maps, cam, x, y, w, cam_k, lvl,
                                          self.takes_levels)
        _check(gout.shape == (bs, M0, C), f"{k}: gout must be [bs, M0, C], got {tuple(gout.shape)}")
        dev = x.device
        _check_tensor("gout", gout, dev, (torch.float32,), k)
        dmaps = [torch.zeros(fm.shape, dtype=torch.float32, device=dev) for fm in fine_maps]
        for i, d in enumerate(dmaps):  # 16-byte reductions
            _check_tensor(f"d level {i}", d, dev, (torch.float32,), k)
        dx = torch.empty_like(x)
        dy = torch.empty_like(y)
        dw = torch.empty_like(w)
        pad = [0] * (_MAX_LEVELS - len(fine_maps))
        hs, ws = _level_args(fine_maps)
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_patch_sample_bwd(
                *[fm.data_ptr() for fm in fine_maps], *pad,
                *[d.data_ptr() for d in dmaps], *pad, *hs, *ws, len(fine_maps),
                int(fine_maps[0].dtype == torch.bfloat16), cam.data_ptr(), x.data_ptr(),
                y.data_ptr(), w.data_ptr(), None if lvl is None else lvl.data_ptr(), n,
                gout.data_ptr(), dx.data_ptr(), dy.data_ptr(), dw.data_ptr(), bs, cams, C, G,
                M0, cam_k, _stream(dev))
        _launched(k, err)
        self.launches += 1
        return dmaps, dx, dy, dw


class RowGather:
    """P2-P4 (``csrc/row_gather.cu``): ``out[i] = table[idx[stride * i]]``
    over whole rows; replaces one of the Pallas gather probes of
    ``tools/probe_pallas_gather.py``. One instance per probe, each with its
    table dtype, its stride and its own launch count. Plain version:
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
                                       n_out, self.stride, row_bytes, _stream(dev))
        _launched(k, err)
        self.launches += 1
        return out


def lsa_smem_bytes(R: int, C: int) -> int:
    """Shared memory of one block of K3: v, minv (fp64), p, way (int32) and
    used (one byte) per padded column, u (fp64) per row."""
    return (C + R + 1) * (2 * 8 + 2 * 4 + 1) + R * 8


class LsaAssign:
    """K3 (``csrc/lsa_assign.cu``): the exact assignment of every ``[R, C]``
    cost matrix of a batch, one block per matrix; replaces
    ``hipad_tpu/targets/matching.py:_lsa_single`` with ``assign``. Plain
    version: ``targets/matching.py:assign_plain``, equal bit for bit."""

    name = "lsa_assign"

    def __init__(self):
        self.launches = 0

    def __call__(self, cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
        """cost ``[n, R, C]`` fp32, row_mask ``[n, R]`` bool -> col4row
        ``[n, R]`` int32 on the card: the column of each row, -1 for an
        invalid row and for a row left without a real column (more valid
        rows than columns)."""
        k = "K3 lsa_assign"
        _check(cost.is_cuda, f"{k}: takes CUDA tensors, got {cost.device}")
        dev = cost.device
        _check(cost.dim() == 3 and row_mask.shape == cost.shape[:2],
               f"{k}: cost must be [n, R, C] and row_mask [n, R], got {tuple(cost.shape)}, "
               f"{tuple(row_mask.shape)}")
        n, R, C = cost.shape
        _check(lsa_smem_bytes(R, C) <= _SMEM_PER_BLOCK,
               f"{k}: [{R}, {C}] needs {lsa_smem_bytes(R, C)} B of shared memory a block, "
               f"more than {_SMEM_PER_BLOCK}")
        _check_tensor("cost", cost, dev, (torch.float32,), k, align=4)
        _check_tensor("row_mask", row_mask, dev, (torch.bool,), k, align=1)
        out = torch.empty(n, R, dtype=torch.int32, device=dev)
        lib = library().lib
        with torch.cuda.device(dev):
            err = lib.hipad_lsa_assign(cost.data_ptr(), row_mask.data_ptr(), out.data_ptr(),
                                       n, R, C, _stream(dev))
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
KERNELS = (coarse_sample, patch_sample, interp_sample_camsum_bwd, patch_sample_bwd,
           gather_rows_f32, gather_rows_bf16, gather_rows_f32_every8, patch_sample_lk,
           patch_sample_bwd_lk, lsa_assign)
