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
// What bounds it on this card: the atomic reductions into d fm, which the
// L2 executes, and the gathered rows (<= 4 rows of C channels per slot and
// level, from maps of 88x160 and 44x80 cells, where few samples share a
// cell). Design: one warp per (b, m0) output row as in the forward, the
// upstream row held in registers for every slot and level; d w, d x, d y
// reduced inside the warp and stored once; d fm by two 16-byte fp32
// reductions per lane and tap (atomicAdd on float4, a quarter of the
// operations scalar atomics take) into zeroed fp32 buffers (cast to the
// maps' dtype by the caller). p, q are rounded as the forward and the plain
// version round them (__fmul_rn), so the patch origin is the same.
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
  float* dfm[kMaxLevels];   // fp32, same shapes
  int H[kMaxLevels];
  int W[kMaxLevels];
  int n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_sample_bwd_kernel(FineLevels<T> lv, const int* __restrict__ cam,
                        const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ w,
                        const int* __restrict__ lvl, int level_k,
                        const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ dy,
                        float* __restrict__ dw, int bs, int cams, int C,
                        int G, int M0, int cam_k) {
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
        const long long base = (static_cast<long long>(b) * cams + c) * H * W * C;
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
            if (wxy == 0.f && ddx == 0.f && ddy == 0.f) continue;
            const long long off = base + (static_cast<long long>(sy + i) * W + sx + j) * C;
            float v[kMaxChunks][kVec];
            hipad::load_row(lv.fm[l] + off, v, C, lane);
            float d = 0.f;
            hipad::tap_backward(v, go, wrow, wxy, part, d, C, gd, lane, lv.dfm[l] + off);
            lx = fmaf(ddx, d, lx);
            ly = fmaf(ddy, d, ly);
          }
        }
        ax = fmaf(static_cast<float>(W), lx, ax);
        ay = fmaf(static_cast<float>(H), ly, ay);
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
void launch(const void* const* fms, void* const* dfms, const int* Hs,
            const int* Ws, int nlev, const void* cam, const void* x,
            const void* y, const void* w, const void* lvl, int level_k,
            const void* gout, void* dx, void* dy, void* dw, int bs, int cams,
            int C, int G, int M0, int cam_k, cudaStream_t st) {
  FineLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.fm[l] = static_cast<const T*>(fms[l]);
    lv.dfm[l] = static_cast<float*>(dfms[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
  }
  lv.n = nlev;
  const long long rows = static_cast<long long>(bs) * M0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  patch_sample_bwd_kernel<T><<<blocks, kThreads, 0, st>>>(
      lv, static_cast<const int*>(cam), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const int*>(lvl), level_k, static_cast<const float*>(gout),
      static_cast<float*>(dx),
      static_cast<float*>(dy), static_cast<float*>(dw), bs, cams, C, G, M0,
      cam_k);
}

}  // namespace

// fm0..fm3: fine-level maps [bs, cams, H_l, W_l, C] (fp32, or bf16 when
// fm_bf16 != 0) and dfm0..dfm3 their fp32 gradients, zeroed by the caller,
// the first nlev used; cam [bs, M] int32; x, y [bs, M] fp32; w [bs, M, n, G]
// fp32 with n = nlev, or n = level_k when lvl [bs, M, level_k] int32 is
// given; gout [bs, M0, C] fp32; M = M0*cam_k. Outputs dx, dy [bs, M] and
// dw [bs, M, n, G] fp32, every element written here.
// Returns cudaGetLastError() after the launch.
extern "C" int hipad_patch_sample_bwd(
    const void* fm0, const void* fm1, const void* fm2, const void* fm3,
    void* dfm0, void* dfm1, void* dfm2, void* dfm3, int H0, int H1, int H2,
    int H3, int W0, int W1, int W2, int W3, int nlev, int fm_bf16,
    const void* cam, const void* x, const void* y, const void* w,
    const void* lvl, int level_k, const void* gout, void* dx, void* dy,
    void* dw, int bs, int cams, int C, int G, int M0, int cam_k,
    void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || (lvl != nullptr && level_k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fms[kMaxLevels] = {fm0, fm1, fm2, fm3};
  void* dfms[kMaxLevels] = {dfm0, dfm1, dfm2, dfm3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fm_bf16) {
    launch<__nv_bfloat16>(fms, dfms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k,
                          gout, dx, dy, dw, bs, cams, C, G, M0, cam_k, st);
  } else {
    launch<float>(fms, dfms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k, gout, dx,
                  dy, dw, bs, cams, C, G, M0, cam_k, st);
  }
  return static_cast<int>(cudaGetLastError());
}
