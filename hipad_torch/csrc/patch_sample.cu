// K2: fine-level patch sampling of camera-compacted samples.
//
// Replaces the fine-level loop of
// hipad_tpu/ops/sampling.py:deformable_samples_topk_flat (levels not in
// matmul_levels), which calls patch_bilinear_w once per level and sums the
// result over the cam_k slots. Counterpart of the reference's own CUDA op
// (deformable_aggregation_cuda.cu) on compacted samples.
//
//   out[b, m0, c] = sum_{k < cam_k} sum_l w[b, s, l, c/(C/G)]
//                   * sum_{i,j<2} wy_i wx_j fm_l[b, cam[b,s], sy+i, sx+j, c]
//   s = m0*cam_k + k;  p = x*W_l - 0.5, q = y*H_l - 0.5
//   sy = clamp(floor(q), 0, H_l-2), sx = clamp(floor(p), 0, W_l-2)
//   wy_i = max(0, 1 - |q - sy - i|), wx_j = max(0, 1 - |p - sx - j|)
//
// The hat weights taken against the clamped origin give corners outside the
// map weight zero, exactly as the JAX gather with its clamped origin does.
//
// What bounds it on this card: gathered bytes. Each (sample, kept camera,
// fine level) reads up to 4 rows of C*sizeof(T) bytes from maps of 88x160
// and 44x80 cells (27 MB fp32 for 6 cameras at C=256); the plain version
// writes a [bs, M, 4, C] patch tensor to device memory and reads it back.
// Design: one warp per output row, 16-byte coalesced loads, fp32 register
// accumulation over slots, levels and corners, one write per row; samples
// with all-zero group weights and zero-weight corners skip their loads.
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
  int n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_sample_kernel(FineLevels<T> lv, const int* __restrict__ cam,
                    const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ w, float* __restrict__ out,
                    int bs, int cams, int C, int G, int M0, int cam_k) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(bs) * M0) return;
  const int b = static_cast<int>(row / M0);
  const int m0 = static_cast<int>(row - static_cast<long long>(b) * M0);
  const int gd = C / G;
  const long long M = static_cast<long long>(M0) * cam_k;

  float acc[kMaxChunks][kVec];
  hipad::zero_acc(acc);
  for (int k = 0; k < cam_k; ++k) {
    const long long s = b * M + static_cast<long long>(m0) * cam_k + k;
    const int c = cam[s];
    if (c < 0 || c >= cams) continue;
    const float xs = x[s];
    const float ys = y[s];
    for (int l = 0; l < lv.n; ++l) {
      const float* wrow = w + (s * lv.n + l) * G;
      if (!hipad::any_nonzero(wrow, G)) continue;
      const int H = lv.H[l];
      const int W = lv.W[l];
      // no fused multiply-add: keep p, q rounded as the plain version does
      const float p = __fmul_rn(xs, static_cast<float>(W)) - 0.5f;
      const float q = __fmul_rn(ys, static_cast<float>(H)) - 0.5f;
      const float sxf = fminf(fmaxf(floorf(p), 0.f), static_cast<float>(W - 2));
      const float syf = fminf(fmaxf(floorf(q), 0.f), static_cast<float>(H - 2));
      const int sx = static_cast<int>(sxf);
      const int sy = static_cast<int>(syf);
      const T* img =
          lv.fm[l] + (static_cast<long long>(b) * cams + c) * H * W * C;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float wy = fmaxf(0.f, 1.f - fabsf(q - (syf + i)));
        if (wy == 0.f) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float wx = fmaxf(0.f, 1.f - fabsf(p - (sxf + j)));
          if (wx == 0.f) continue;
          hipad::accumulate_row(
              acc, img + (static_cast<long long>(sy + i) * W + sx + j) * C,
              wrow, wy * wx, C, gd, lane);
        }
      }
    }
  }
  hipad::store_row(out + row * C, acc, C, lane);
}

template <typename T>
void launch(const void* const* fms, const int* Hs, const int* Ws, int nlev,
            const void* cam, const void* x, const void* y, const void* w,
            void* out, int bs, int cams, int C, int G, int M0, int cam_k,
            cudaStream_t st) {
  FineLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.fm[l] = static_cast<const T*>(fms[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
  }
  lv.n = nlev;
  const long long rows = static_cast<long long>(bs) * M0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  patch_sample_kernel<T><<<blocks, kThreads, 0, st>>>(
      lv, static_cast<const int*>(cam), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<float*>(out), bs, cams, C, G, M0, cam_k);
}

}  // namespace

// fm0..fm3: fine-level maps [bs, cams, H_l, W_l, C] (fp32, or bf16 when
// fm_bf16 != 0), the first nlev used; cam [bs, M] int32; x, y [bs, M] fp32
// normalised; w [bs, M, nlev, G] fp32; out [bs, M0, C] fp32, M = M0*cam_k.
// Returns cudaGetLastError() after the launch.
extern "C" int hipad_patch_sample(const void* fm0, const void* fm1,
                                  const void* fm2, const void* fm3, int H0,
                                  int H1, int H2, int H3, int W0, int W1,
                                  int W2, int W3, int nlev, int fm_bf16,
                                  const void* cam, const void* x,
                                  const void* y, const void* w, void* out,
                                  int bs, int cams, int C, int G, int M0,
                                  int cam_k, void* stream) {
  if (nlev < 1 || nlev > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  const void* fms[kMaxLevels] = {fm0, fm1, fm2, fm3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fm_bf16) {
    launch<__nv_bfloat16>(fms, Hs, Ws, nlev, cam, x, y, w, out, bs, cams, C,
                          G, M0, cam_k, st);
  } else {
    launch<float>(fms, Hs, Ws, nlev, cam, x, y, w, out, bs, cams, C, G, M0,
                  cam_k, st);
  }
  return static_cast<int>(cudaGetLastError());
}
