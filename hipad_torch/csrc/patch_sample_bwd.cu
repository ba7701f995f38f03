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
// samples share a cell, and the writes of those maps (108 MB at stage 2 in
// fp32); and the gathered rows (<= 4 rows of C channels per slot and
// level). Design (a pull, the order JAX's _dense_fmap_grad sums in): one
// warp per (b, m0) output row as in the forward, the upstream row held in
// registers for every slot and level; d w, d x, d y reduced inside the
// warp and stored once. p, q are rounded as the forward and the plain
// version round them (__fmul_rn), so the patch origin is the same. The row
// kernel writes no d fm: it writes one item per (slot, level) whose taps
// weigh something, binned by (level, camera's map, patch row, segment of
// the patch column), and counts the bins; the binned scatter of
// bin_scatter.cuh orders the items by bin with a stable counting sort and
// sums each cell's taps in that order, a warp per run of 4 cells of every
// level, and writes each cell once in the maps' dtype: no zero fill, no
// atomics, the same bits on every run (ops/kernels.py: k2_bwd_plan).
#include "bin_scatter.cuh"
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
  int H[kMaxLevels];
  int W[kMaxLevels];
  int sw[kMaxLevels];       // columns of a bin's segment, the level's bins from bin0
  int bin0[kMaxLevels];
  int n;
};

// Two blocks an SM: the registers of 128 a thread, as many warps in flight
// as the atomic design kept.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
patch_sample_bwd_kernel(FineLevels<T> lv, const int* __restrict__ cam,
                        const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ w,
                        const int* __restrict__ lvl, int level_k,
                        const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ dy,
                        float* __restrict__ dw, hipad::BinScratch bins, int chunks,
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
      // the item of this (slot, level): its bin where a tap weighs something
      int key = -1;
      float part[kMaxChunks] = {};
      if (valid && l >= 0 && l < lv.n) {
        // the level's fields, read with constant indices (an index computed
        // at run time would copy the parameters to local memory)
        int H = 0, W = 0, sw = 1, bin0 = 0;
        const T* fm = nullptr;
#pragma unroll
        for (int q = 0; q < kMaxLevels; ++q) {
          if (q == l) {
            H = lv.H[q];
            W = lv.W[q];
            sw = lv.sw[q];
            bin0 = lv.bin0[q];
            fm = lv.fm[q];
          }
        }
        const float p = __fmul_rn(xs, static_cast<float>(W)) - 0.5f;
        const float q = __fmul_rn(ys, static_cast<float>(H)) - 0.5f;
        const float sxf = fminf(fmaxf(floorf(p), 0.f), static_cast<float>(W - 2));
        const float syf = fminf(fmaxf(floorf(q), 0.f), static_cast<float>(H - 2));
        const int sx = static_cast<int>(sxf);
        const int sy = static_cast<int>(syf);
        float lx = 0.f, ly = 0.f;
        bool any = false;
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
            any |= wxy != 0.f;
            if (wxy == 0.f && ddx == 0.f && ddy == 0.f) continue;
            const long long off = cell * C;
            float v[kMaxChunks][kVec];
            hipad::load_row(fm + off, v, C, lane);
            float d = 0.f;
            hipad::tap_backward(v, go, wrow, wxy, part, d, C, gd, lane);
            lx = fmaf(ddx, d, lx);
            ly = fmaf(ddy, d, ly);
          }
        }
        ax = fmaf(static_cast<float>(W), lx, ax);
        ay = fmaf(static_cast<float>(H), ly, ay);
        if (any) {
          const int nseg = (W + sw - 1) / sw;
          key = bin0 + static_cast<int>(((static_cast<long long>(b) * cams + c) * (H - 1) + sy) *
                                            nseg + sx / sw);
        }
      }
      if (lane == 0) {
        hipad::bin_item(bins.keys, bins.items, bins.hist, chunks, s * n + jl, key, xs, ys,
                        static_cast<int>(s * n + jl), static_cast<int>(row));
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

template <typename T>
cudaError_t launch(const void* const* fms, void* const* dfms, const int* Hs, const int* Ws,
                   int nlev, const void* cam, const void* x, const void* y, const void* w,
                   const void* lvl, int level_k, const void* gout, void* dx, void* dy,
                   void* dw, const hipad::BinScratch& bins, const hipad::BinPlan& plan, int bs,
                   int cams, int C, int G, int M0, int cam_k, cudaStream_t st) {
  FineLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.fm[l] = static_cast<const T*>(fms[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
    lv.sw[l] = plan.sw[l];
    lv.bin0[l] = plan.bin0[l];
  }
  lv.n = nlev;
  const long long rows = static_cast<long long>(bs) * M0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const int n = lvl != nullptr ? level_k : nlev;
  cudaError_t err = hipad::bin_begin(bins, plan, st);
  if (err != cudaSuccess) return err;
  patch_sample_bwd_kernel<T><<<blocks, kThreads, 0, st>>>(
      lv, static_cast<const int*>(cam), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const int*>(lvl), level_k, static_cast<const float*>(gout),
      static_cast<float*>(dx), static_cast<float*>(dy), static_cast<float*>(dw), bins,
      plan.chunks, bs, cams, C, G, M0, cam_k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  T* out[kMaxLevels] = {};
  for (int l = 0; l < nlev; ++l) out[l] = static_cast<T*>(dfms[l]);
  return hipad::bin_finish<T>(bins, plan, rows * cam_k * n, out, Hs, Ws, hipad::K2Geo{},
                              static_cast<const float*>(gout), static_cast<const float*>(w), C,
                              G, st);
}

}  // namespace

// fm0..fm3: fine-level maps [bs, cams, H_l, W_l, C] (fp32, or bf16 when
// fm_bf16 != 0), the first nlev used; cam [bs, M] int32; x, y [bs, M] fp32;
// w [bs, M, n, G] fp32 with n = nlev, or n = level_k when lvl [bs, M,
// level_k] int32 is given; gout [bs, M0, C] fp32; M = M0*cam_k. Outputs dx,
// dy [bs, M] and dw [bs, M, n, G] fp32 and dfm0..dfm3 [bs, cams, H_l, W_l,
// C] in the maps' dtype, every element written here. keys, items, hist, tot,
// out, start: the scratch of hipad::BinScratch; plan: the host ints of
// ops/kernels.py:k2_bwd_plan (a level per fine map, tb0 = 0: bin rows are
// the patch origins 0 .. H_l - 2). Returns the first CUDA error of the six
// launches (the counts' zero fill, the row kernel, the two scans, the placement,
// the cells), or 0.
extern "C" int hipad_patch_sample_bwd(
    const void* fm0, const void* fm1, const void* fm2, const void* fm3,
    void* dfm0, void* dfm1, void* dfm2, void* dfm3, int H0, int H1, int H2,
    int H3, int W0, int W1, int W2, int W3, int nlev, int fm_bf16,
    const void* cam, const void* x, const void* y, const void* w,
    const void* lvl, int level_k, const void* gout, void* dx, void* dy,
    void* dw, int bs, int cams, int C, int G, int M0, int cam_k, void* keys, void* items,
    void* hist, void* tot, void* out, void* start, const int* plan, void* stream) {
  const void* fms[kMaxLevels] = {fm0, fm1, fm2, fm3};
  void* dfms[kMaxLevels] = {dfm0, dfm1, dfm2, dfm3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  hipad::BinPlan p;
  if (nlev < 1 || nlev > kMaxLevels || (lvl != nullptr && level_k < 1) ||
      !hipad::read_plan(plan, p) || p.n != nlev)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < nlev; ++l) {
    if (p.tb0[l] != 0 || p.rowbins[l] != Hs[l] - 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const hipad::BinScratch bins{static_cast<int*>(keys), static_cast<hipad::BinItem*>(items),
                               static_cast<int*>(hist), static_cast<int*>(tot),
                               static_cast<hipad::BinItem*>(out), static_cast<int*>(start)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      fm_bf16 ? launch<__nv_bfloat16>(fms, dfms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k, gout,
                                      dx, dy, dw, bins, p, bs, cams, C, G, M0, cam_k, st)
              : launch<float>(fms, dfms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k, gout, dx, dy,
                              dw, bins, p, bs, cams, C, G, M0, cam_k, st);
  return static_cast<int>(err);
}
