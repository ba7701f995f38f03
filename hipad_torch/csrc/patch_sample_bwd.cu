// K2-bwd: the adjoint of K2 (patch_sample.cu), fine-level patch sampling of
// camera-compacted samples, over every fine level and cam_k slot in one
// launch.
//
// Replaces hipad_tpu/ops/sampling.py:_patch_bilinear_w_bwd (the custom_vjp
// backward of patch_bilinear_w: d wy, d wx, d wg from a re-gathered patch)
// with its feature-map adjoint _dense_fmap_grad (chunked one-hot einsums on
// the TPU's matrix unit, because scatters there are serialised), and the
// autodiff of the hat weights wy, wx back to the continuous coordinates.
// With go = d out [bs, M0, C], slot s = m0*cam_k + k, level l and
//   p = x*W_l - 0.5, q = y*H_l - 0.5, sx, sy the clamped patch origin,
//   wy_i = hat(q - sy - i), wx_j = hat(p - sx - j):
//
//   d fm_l[b, cam, sy+i, sx+j, c] += wy_i wx_j w[s, l, c/(C/G)] go[b, m0, c]
//   d w[s, l, g] = sum_ij wy_i wx_j sum_{c in g} fm_l[..] go
//   d x[s] = sum_l W_l sum_ij wy_i hat'(p - sx - j) sum_c w fm go   (d y alike)
//
// The integer origin gets no gradient; a corner that weighs zero after the
// clamp gets none either (hat' is zero there but at the kink, where the JAX
// convention of sample_common.cuh gives 1/2, as JAX does).
//
// Level-k variant (sampler_level_k, patch_sample.cu): given lvl [bs, M,
// level_k] int32, slot j of sample s is level lvl[s, j], its weights w[s, j]
// ([bs, M, level_k, G]) and d w[s, j] likewise; only the kept patches
// scatter into their level's d fm. JAX's level-k path differentiates
// through patch_bilinear_w's custom VJP on the combined pyramid, whose pad
// gets no gradient; the chain through the level selection and the
// renormalisation stays in autograd (ops/sampling.py).
//
// What bounds it on this card: the map gradient, whose ~190,000 adds
// (slot, level, tap) land in maps of 88x160 and 44x80 cells, where few
// samples share a cell, and the gathered rows (<= 4 rows of C channels per
// slot and level). Design: one warp per (b, m0) output row as in the
// forward, the upstream row held in registers for every slot and level;
// d w, d x, d y reduced inside the warp and stored once. p, q are rounded as
// the forward and the plain version round them (__fmul_rn), so the patch
// origin is the same. Two routes for d fm (ops/kernels.py: PatchSampleBwd
// picks one by torch.are_deterministic_algorithms_enabled()):
//
//  * atomic: the row kernel adds wy wx w go of every tap into zeroed fp32
//    maps by two 16-byte fp32 reductions per lane and tap (atomicAdd on
//    float4), which the L2 executes in whatever order the warps arrive: the
//    sum's rounding changes from run to run.
//  * deterministic (a pull, the order JAX's _dense_fmap_grad sums in): the
//    row kernel writes, for every (slot, level, tap) item, the index of the
//    cell it adds into (or past the last cell for an item that adds
//    nothing) and no d fm; the wrapper orders the items by cell with a
//    stable sort of those integer keys, so that the items of a cell keep
//    their (slot, level, tap) order, and finds where each cell's run starts
//    (ops/kernels.py: contribution_index). Then the cell kernel, one warp
//    per cell of every level, lanes on channels, sums its cell's items in
//    that order in fp32 registers and writes the cell once, in the maps'
//    dtype: no zero fill, no atomics, the same bits on every run.
#include <climits>

#include "sample_common.cuh"

namespace {

using hipad::kMaxChunks;
using hipad::kThreads;
using hipad::kVec;
using hipad::kWarps;

constexpr int kMaxLevels = 4;

template <typename T>
struct FineLevels {
  const T* fm[kMaxLevels];  // [bs, cams, H, W, C] each
  float* dfm[kMaxLevels];   // fp32, same shapes (the atomic route)
  int H[kMaxLevels];
  int W[kMaxLevels];
  int first[kMaxLevels + 1];  // level l's cells are [first[l], first[l+1]) of all levels'
  int n;
};

// kKeys: the deterministic route's row kernel (keys, no d fm), else the
// atomic route's (d fm by reductions, no keys).
template <typename T, bool kKeys>
__global__ void __launch_bounds__(kThreads)
patch_sample_bwd_kernel(FineLevels<T> lv, const int* __restrict__ cam,
                        const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ w,
                        const int* __restrict__ lvl, int level_k,
                        const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ dy,
                        float* __restrict__ dw, int* __restrict__ keys,
                        int bs, int cams, int C, int G, int M0, int cam_k) {
  __shared__ float red[kWarps][32 * kMaxChunks];
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(bs) * M0) return;
  const int b = static_cast<int>(row / M0);
  const int m0 = static_cast<int>(row - static_cast<long long>(b) * M0);
  const int gd = C / G;
  const long long M = static_cast<long long>(M0) * cam_k;
  const int n = lvl != nullptr ? level_k : lv.n;  // level slots of a sample

  float go[kMaxChunks][kVec];
  hipad::load_row(gout + row * C, go, C, lane);

  for (int k = 0; k < cam_k; ++k) {
    const long long s = b * M + static_cast<long long>(m0) * cam_k + k;
    const int c = cam[s];
    const bool valid = c >= 0 && c < cams;
    const float xs = x[s];
    const float ys = y[s];
    float ax = 0.f, ay = 0.f;
    for (int jl = 0; jl < n; ++jl) {
      const int l = lvl != nullptr ? lvl[s * level_k + jl] : jl;
      const float* wrow = w + (s * n + jl) * G;
      // the deterministic route's keys of this (slot, level)'s four taps:
      // the cell each adds into, or past the last cell
      int* key = kKeys && lane == 0 ? keys + (s * n + jl) * 4 : nullptr;
      float part[kMaxChunks] = {};
      if (valid && l >= 0 && l < lv.n) {
        const int H = lv.H[l];
        const int W = lv.W[l];
        const float p = __fmul_rn(xs, static_cast<float>(W)) - 0.5f;
        const float q = __fmul_rn(ys, static_cast<float>(H)) - 0.5f;
        const float sxf = fminf(fmaxf(floorf(p), 0.f), static_cast<float>(W - 2));
        const float syf = fminf(fmaxf(floorf(q), 0.f), static_cast<float>(H - 2));
        const int sx = static_cast<int>(sxf);
        const int sy = static_cast<int>(syf);
        float lx = 0.f, ly = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float ty = q - (syf + i);
          const float wy = hipad::hat(ty);
          const float dwy = hipad::hat_grad(ty);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float tx = p - (sxf + j);
            const float wx = hipad::hat(tx);
            const float dwx = hipad::hat_grad(tx);
            const float wxy = wy * wx;
            const float ddx = wy * dwx;
            const float ddy = dwy * wx;
            const long long cell = (static_cast<long long>(b) * cams + c) * H * W +
                                   static_cast<long long>(sy + i) * W + sx + j;
            if (key != nullptr) {
              key[2 * i + j] = wxy != 0.f ? lv.first[l] + static_cast<int>(cell)
                                          : lv.first[lv.n];
            }
            if (wxy == 0.f && ddx == 0.f && ddy == 0.f) continue;
            const long long off = cell * C;
            float v[kMaxChunks][kVec];
            hipad::load_row(lv.fm[l] + off, v, C, lane);
            float d = 0.f;
            hipad::tap_backward(v, go, wrow, wxy, part, d, C, gd, lane,
                                kKeys ? nullptr : lv.dfm[l] + off);
            lx = fmaf(ddx, d, lx);
            ly = fmaf(ddy, d, ly);
          }
        }
        ax = fmaf(static_cast<float>(W), lx, ax);
        ay = fmaf(static_cast<float>(H), ly, ay);
      } else if (key != nullptr) {
        for (int t = 0; t < 4; ++t) key[t] = lv.first[lv.n];
      }
      hipad::store_group_sums(red[warp], part, dw + (s * n + jl) * G, C, G, lane);
    }
    ax = hipad::warp_sum(ax);
    ay = hipad::warp_sum(ay);
    if (lane == 0) {
      dx[s] = ax;
      dy[s] = ay;
    }
  }
}

// The deterministic route's second launch: the cells of every level, each
// level's gradient in the maps' dtype.
template <typename T>
struct CellLevels {
  T* dfm[kMaxLevels];  // [bs, cams, H, W, C] each
  int H[kMaxLevels];
  int W[kMaxLevels];
  int first[kMaxLevels + 1];  // as FineLevels::first
  int n;
};

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// One warp per cell of every level (lanes on channels, kVec a lane and
// chunk, NCH chunks): d fm[cell] = the sum, in the order the wrapper's
// stable sort left them, of wy wx w go over the items order[starts[cell] ..
// starts[cell+1]), each item ((s * n + jl) * 4 + tap) re-deriving its hat
// weights from its slot's (x, y) as the row kernel did; written once, zero
// for a cell that no item reaches. The lanes prepare 32 items at once (lane
// q: item q's upstream row, weights' row and wxy), so the chain of reads an
// item needs (its index, then its coordinates) is paid once per 32; then
// the warp reads the upstream rows of B items at a time and adds them in
// order. Indices fit an int (the wrapper checks), so no 64-bit division.
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
patch_sample_bwd_cells_kernel(CellLevels<T> lv, const int* __restrict__ starts,
                              const long long* __restrict__ order,
                              const float* __restrict__ x,
                              const float* __restrict__ y,
                              const float* __restrict__ w,
                              const float* __restrict__ gout, int n, int C,
                              int G, int M0, int cam_k) {
  constexpr int B = hipad::batch_taps<NCH>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= lv.first[lv.n]) return;
  // the cell's level, read with constant indices (an index computed at run
  // time would copy the parameters to local memory)
  int H = 0, W = 0, first = 0;
  T* dfm = nullptr;
#pragma unroll
  for (int q = 0; q < kMaxLevels; ++q) {
    if (q < lv.n && cell >= lv.first[q]) {
      H = lv.H[q];
      W = lv.W[q];
      first = lv.first[q];
      dfm = lv.dfm[q];
    }
  }
  const int gd = C / G;
  const int M = M0 * cam_k;
  float acc[NCH][kVec] = {};
  const int end = starts[cell + 1];
  for (int t0 = starts[cell]; t0 < end; t0 += 32) {
    int row = 0, wr = 0;  // lane q: item t0 + q's upstream row and weights' row
    float wxy = 0.f;
    if (t0 + lane < end) {
      const int item = static_cast<int>(order[t0 + lane]);
      wr = item >> 2;  // s * n + jl
      const int s = wr / n;
      const int i = (item >> 1) & 1;
      const int j = item & 1;
      const float p = __fmul_rn(x[s], static_cast<float>(W)) - 0.5f;
      const float q = __fmul_rn(y[s], static_cast<float>(H)) - 0.5f;
      const float sxf = fminf(fmaxf(floorf(p), 0.f), static_cast<float>(W - 2));
      const float syf = fminf(fmaxf(floorf(q), 0.f), static_cast<float>(H - 2));
      wxy = hipad::hat(q - (syf + i)) * hipad::hat(p - (sxf + j));
      const int b = s / M;
      row = b * M0 + (s - b * M) / cam_k;
    }
    const int cnt = min(32, end - t0);
    for (int q0 = 0; q0 < cnt; q0 += B) {
      float g[B][NCH][kVec];
      float sc[B][NCH];
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const int src = (q0 + k) & 31;
        const long long rq = __shfl_sync(0xffffffffu, row, src);
        const long long wq = __shfl_sync(0xffffffffu, wr, src);
        const float aq = __shfl_sync(0xffffffffu, wxy, src);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int c0 = (ch * 32 + lane) * kVec;
          if (q0 + k < cnt && c0 < C) {
            hipad::load8(gout + rq * C + c0, g[k][ch]);
            sc[k][ch] = aq * w[wq * G + c0 / gd];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < B; ++k) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int c0 = (ch * 32 + lane) * kVec;
          if (q0 + k < cnt && c0 < C) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[ch][e] = fmaf(sc[k][ch], g[k][ch][e], acc[ch][e]);
          }
        }
      }
    }
  }
  T* out = dfm + static_cast<long long>(cell - first) * C;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int c0 = (ch * 32 + lane) * kVec;
    if (c0 < C) store8(out + c0, acc[ch]);
  }
}

// level l's cells start at first[l] of all levels' -> the cells of all, or
// -1 where they exceed an int
int level_firsts(const int* Hs, const int* Ws, int nlev, int bs, int cams, int* first) {
  long long total = 0;
  for (int l = 0; l < nlev; ++l) {
    first[l] = static_cast<int>(total);
    total += static_cast<long long>(bs) * cams * Hs[l] * Ws[l];
    if (total >= INT_MAX) return -1;
  }
  first[nlev] = static_cast<int>(total);
  return first[nlev];
}

template <typename T>
void launch(const void* const* fms, void* const* dfms, const int* Hs,
            const int* Ws, int nlev, const void* cam, const void* x,
            const void* y, const void* w, const void* lvl, int level_k,
            const void* gout, void* dx, void* dy, void* dw, void* keys, int bs,
            int cams, int C, int G, int M0, int cam_k, cudaStream_t st) {
  FineLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.fm[l] = static_cast<const T*>(fms[l]);
    lv.dfm[l] = static_cast<float*>(dfms[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
  }
  lv.n = nlev;
  level_firsts(Hs, Ws, nlev, bs, cams, lv.first);
  const long long rows = static_cast<long long>(bs) * M0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  auto* kernel = keys != nullptr ? patch_sample_bwd_kernel<T, true>
                                 : patch_sample_bwd_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, st>>>(
      lv, static_cast<const int*>(cam), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const int*>(lvl), level_k, static_cast<const float*>(gout),
      static_cast<float*>(dx), static_cast<float*>(dy), static_cast<float*>(dw),
      static_cast<int*>(keys), bs, cams, C, G, M0, cam_k);
}

template <typename T>
void launch_cells(void* const* dfms, const int* Hs, const int* Ws, int nlev,
                  const void* starts, const void* order, const void* x,
                  const void* y, const void* w, int n, const void* gout, int bs,
                  int cams, int C, int G, int M0, int cam_k, cudaStream_t st) {
  CellLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.dfm[l] = static_cast<T*>(dfms[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
  }
  lv.n = nlev;
  const int cells = level_firsts(Hs, Ws, nlev, bs, cams, lv.first);
  const unsigned blocks = static_cast<unsigned>((cells + kWarps - 1) / kWarps);
  auto* kernel = patch_sample_bwd_cells_kernel<T, kMaxChunks>;
  switch ((C + 32 * kVec - 1) / (32 * kVec)) {
    case 1: kernel = patch_sample_bwd_cells_kernel<T, 1>; break;
    case 2: kernel = patch_sample_bwd_cells_kernel<T, 2>; break;
    case 3: kernel = patch_sample_bwd_cells_kernel<T, 3>; break;
  }
  kernel<<<blocks, kThreads, 0, st>>>(
      lv, static_cast<const int*>(starts), static_cast<const long long*>(order),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<const float*>(gout), n, C, G, M0, cam_k);
}

}  // namespace

// fm0..fm3: fine-level maps [bs, cams, H_l, W_l, C] (fp32, or bf16 when
// fm_bf16 != 0), the first nlev used; cam [bs, M] int32; x, y [bs, M] fp32;
// w [bs, M, n, G] fp32 with n = nlev, or n = level_k when lvl [bs, M,
// level_k] int32 is given; gout [bs, M0, C] fp32; M = M0*cam_k. Outputs dx,
// dy [bs, M] and dw [bs, M, n, G] fp32, every element written here; and
// either (keys null: the atomic route) dfm0..dfm3, fp32 gradients of the
// maps zeroed by the caller, added into, or (keys [bs * M * n * 4] int32:
// the deterministic route) no d fm but, for item (s * n + jl) * 4 + 2i + j,
// the cell it adds into (level l's cells numbered from the cells of the
// levels before it, each level [bs, cams, H_l, W_l]) or, for an item that
// adds nothing, the number of all cells.
// Returns cudaGetLastError() after the launch.
extern "C" int hipad_patch_sample_bwd(
    const void* fm0, const void* fm1, const void* fm2, const void* fm3,
    void* dfm0, void* dfm1, void* dfm2, void* dfm3, int H0, int H1, int H2,
    int H3, int W0, int W1, int W2, int W3, int nlev, int fm_bf16,
    const void* cam, const void* x, const void* y, const void* w,
    const void* lvl, int level_k, const void* gout, void* dx, void* dy,
    void* dw, void* keys, int bs, int cams, int C, int G, int M0, int cam_k,
    void* stream) {
  const void* fms[kMaxLevels] = {fm0, fm1, fm2, fm3};
  void* dfms[kMaxLevels] = {dfm0, dfm1, dfm2, dfm3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  int first[kMaxLevels + 1];
  if (nlev < 1 || nlev > kMaxLevels || (lvl != nullptr && level_k < 1) ||
      level_firsts(Hs, Ws, nlev, bs, cams, first) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fm_bf16) {
    launch<__nv_bfloat16>(fms, dfms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k,
                          gout, dx, dy, dw, keys, bs, cams, C, G, M0, cam_k, st);
  } else {
    launch<float>(fms, dfms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k, gout, dx,
                  dy, dw, keys, bs, cams, C, G, M0, cam_k, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deterministic route's second launch: dfm0..dfm3 [bs, cams, H_l, W_l,
// C] in the maps' dtype (bf16 when dfm_bf16 != 0), every element written
// here, from the row kernel's items ordered by cell: order [items] int64
// (a stable argsort of its keys) and starts [cells + 1] int32 (where each
// cell's run begins, the last entry where the items that add nothing
// begin); x, y, w, gout, n (level slots a sample) and the sizes as for
// hipad_patch_sample_bwd. Returns cudaGetLastError() after the launch.
extern "C" int hipad_patch_sample_bwd_cells(
    void* dfm0, void* dfm1, void* dfm2, void* dfm3, int H0, int H1, int H2,
    int H3, int W0, int W1, int W2, int W3, int nlev, int dfm_bf16,
    const void* starts, const void* order, const void* x, const void* y,
    const void* w, int n, const void* gout, int bs, int cams, int C, int G,
    int M0, int cam_k, void* stream) {
  void* dfms[kMaxLevels] = {dfm0, dfm1, dfm2, dfm3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  int first[kMaxLevels + 1];
  if (nlev < 1 || nlev > kMaxLevels || n < 1 ||
      level_firsts(Hs, Ws, nlev, bs, cams, first) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dfm_bf16) {
    launch_cells<__nv_bfloat16>(dfms, Hs, Ws, nlev, starts, order, x, y, w, n, gout, bs,
                                cams, C, G, M0, cam_k, st);
  } else {
    launch_cells<float>(dfms, Hs, Ws, nlev, starts, order, x, y, w, n, gout, bs, cams, C,
                        G, M0, cam_k, st);
  }
  return static_cast<int>(cudaGetLastError());
}
