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
// The sum runs over (slot, level, i, j) in that order.
//
// Level-k variant (sampler_level_k; replaces the combined-pyramid loop of
// deformable_samples_topk_flat, hipad_tpu/ops/sampling.py:791-830): given
// lvl [bs, M, level_k] int32, sample s reads only its level_k kept fine
// levels, slot j at level lvl[s, j] with that level's own map, H, W and
// clip caps, weighted by w[b, s, j, :] ([bs, M, level_k, G]); the sum runs
// over (slot, kept level, i, j). JAX pads every fine level to the largest
// and stacks them into one pyramid for a static-shaped gather; its caps are
// each chosen level's own H-2, W-2, so the pad is never read, and reading
// the chosen level's own map is the same function. lvl == nullptr is the
// kernel above, the same launch and arithmetic.
//
// What bounds it on this card: gathered bytes, and the latency of each. Each
// (sample, kept camera, fine level) reads up to 4 rows of C*sizeof(T) bytes
// from maps of 88x160 and 44x80 cells (108 MB fp32 for 6 cameras at C=256,
// more than the 50 MB L2), so a tap is a round trip to device memory; the
// plain version writes a [bs, M, 4, C] patch tensor to device memory and
// reads it back. Design: one warp per (b, m0) row. Its lanes load the
// cam_k slots' camera and (x, y) and the cam_k x levels x G group weights
// together (32 values at stage 2, one a lane), one lane per (slot, level)
// pair computes the pair's patch origin, taps and hat weights; the live taps
// are listed in shared memory in sum order, then read in batches of 4 (C =
// 256) with every load of a batch in flight before its first FMA; fp32
// registers, one write per row, 16-byte accesses.
#include "sample_common.cuh"

namespace {

using hipad::kFwdThreads;
using hipad::kFwdWarps;
using hipad::kVec;
using hipad::Tap;

constexpr int kMaxLevels = 4;

template <typename T>
struct FineLevels {
  const T* fm[kMaxLevels];  // [bs, cams, H, W, C] each
  int H[kMaxLevels];
  int W[kMaxLevels];
  int n;
};

template <typename T, int NCH>
__global__ void __launch_bounds__(kFwdThreads)
patch_sample_kernel(FineLevels<T> lv, const int* __restrict__ cam,
                    const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ w, const int* __restrict__ lvl,
                    int level_k, float* __restrict__ out,
                    int bs, int cams, int C, int G, int M0, int cam_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // pair p = (slot p / n, level slot p % n): every fine level, or the
  // level_k kept ones
  const int n = lvl != nullptr ? level_k : lv.n;
  const int pairs = cam_k * n;
  unsigned char* mine = smem + warp * hipad::warp_smem_bytes(pairs, G);
  Tap<T>* list = reinterpret_cast<Tap<T>*>(mine);
  float* wg = reinterpret_cast<float*>(mine + pairs * 4 * sizeof(Tap<T>));
  const int k = lane / n;
  const int j_slot = lane - k * n;
  const long long row = static_cast<long long>(blockIdx.x) * kFwdWarps + warp;
  if (row >= static_cast<long long>(bs) * M0) return;
  const int b = static_cast<int>(row / M0);

  // this pair's camera and location and the row's group weights (w's
  // [cam_k, n, G] block of the row is contiguous), all loads issued together
  const long long s = row * cam_k + k;  // = b * M + m0 * cam_k + k
  int c = -1;
  int l = j_slot;
  float xs = 0.f, ys = 0.f;
  if (lane < pairs) {
    c = __ldg(cam + s);
    xs = __ldg(x + s);
    ys = __ldg(y + s);
    if (lvl != nullptr) l = __ldg(lvl + s * level_k + j_slot);
  }
  for (int i = lane; i < pairs * G; i += 32) wg[i] = __ldg(w + row * pairs * G + i);
  __syncwarp();

  Tap<T> tap[4];
  unsigned mask = 0;
  if (lane < pairs && c >= 0 && c < cams && l >= 0 && l < lv.n) {
    bool any = false;
    for (int g = 0; g < G; ++g) any |= wg[lane * G + g] != 0.f;
    if (any) {
      // the pair's level by constant indices: a dynamic index into the
      // kernel's parameters would copy them to local memory
      const T* fm = lv.fm[0];
      int H = lv.H[0], W = lv.W[0];
#pragma unroll
      for (int j = 1; j < kMaxLevels; ++j) {
        if (j == l) {
          fm = lv.fm[j];
          H = lv.H[j];
          W = lv.W[j];
        }
      }
      // no fused multiply-add: keep p, q rounded as the plain version does
      const float p = __fmul_rn(xs, static_cast<float>(W)) - 0.5f;
      const float q = __fmul_rn(ys, static_cast<float>(H)) - 0.5f;
      const float sxf = fminf(fmaxf(floorf(p), 0.f), static_cast<float>(W - 2));
      const float syf = fminf(fmaxf(floorf(q), 0.f), static_cast<float>(H - 2));
      const T* img = fm + ((static_cast<long long>(b) * cams + c) * H * W +
                                 static_cast<long long>(syf) * W + static_cast<int>(sxf)) * C;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = t >> 1;
        const int j = t & 1;
        const float wy = hipad::hat(q - (syf + i));
        const float wx = hipad::hat(p - (sxf + j));
        tap[t] = Tap<T>{img + (static_cast<long long>(i) * W + j) * C, wy * wx, lane};
        if (wy != 0.f && wx != 0.f) mask |= 1u << t;
      }
    }
  }
  const int ntaps = hipad::list_taps(list, tap, mask, lane);

  float tot[NCH][kVec];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) tot[ch][i] = 0.f;
  }
  hipad::sum_taps<T, NCH, hipad::batch_taps<NCH>()>(list, ntaps, wg, pairs, C, G, lane, tot);
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int c0 = (ch * 32 + lane) * kVec;
    if (c0 < C) {
      float4* o = reinterpret_cast<float4*>(out + row * C + c0);
      o[0] = make_float4(tot[ch][0], tot[ch][1], tot[ch][2], tot[ch][3]);
      o[1] = make_float4(tot[ch][4], tot[ch][5], tot[ch][6], tot[ch][7]);
    }
  }
}

template <typename T, int NCH>
void launch_nch(const FineLevels<T>& lv, const void* cam, const void* x, const void* y,
                const void* w, const void* lvl, int level_k, void* out, int bs, int cams,
                int C, int G, int M0, int cam_k, cudaStream_t st) {
  const int n = lvl != nullptr ? level_k : lv.n;
  const int smem = kFwdWarps * hipad::warp_smem_bytes(cam_k * n, G);
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(bs) * M0 + kFwdWarps - 1) / kFwdWarps);
  patch_sample_kernel<T, NCH><<<blocks, kFwdThreads, smem, st>>>(
      lv, static_cast<const int*>(cam), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const int*>(lvl), level_k, static_cast<float*>(out), bs, cams, C, G, M0,
      cam_k);
}

template <typename T>
int launch(const void* const* fms, const int* Hs, const int* Ws, int nlev,
           const void* cam, const void* x, const void* y, const void* w,
           const void* lvl, int level_k, void* out, int bs, int cams, int C, int G,
           int M0, int cam_k, cudaStream_t st) {
  FineLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.fm[l] = static_cast<const T*>(fms[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
  }
  lv.n = nlev;
  switch ((C + 255) / 256) {
    case 1:
      launch_nch<T, 1>(lv, cam, x, y, w, lvl, level_k, out, bs, cams, C, G, M0, cam_k,
                        st);
      break;
    case 2:
      launch_nch<T, 2>(lv, cam, x, y, w, lvl, level_k, out, bs, cams, C, G, M0, cam_k,
                        st);
      break;
    case 3:
      launch_nch<T, 3>(lv, cam, x, y, w, lvl, level_k, out, bs, cams, C, G, M0, cam_k,
                        st);
      break;
    case 4:
      launch_nch<T, 4>(lv, cam, x, y, w, lvl, level_k, out, bs, cams, C, G, M0, cam_k,
                        st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fm0..fm3: fine-level maps [bs, cams, H_l, W_l, C] (fp32, or bf16 when
// fm_bf16 != 0), the first nlev used; cam [bs, M] int32; x, y [bs, M] fp32
// normalised; w [bs, M, n, G] fp32 with n = nlev, or n = level_k when lvl
// [bs, M, level_k] int32 (fine-level indices in [0, nlev)) is given; out
// [bs, M0, C] fp32, M = M0*cam_k. Needs cam_k * n <= 32, C <= 1024,
// (C / G) % 8 == 0 and kFwdWarps * warp_smem_bytes(cam_k * n, G) <= 48 KB
// (the wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int hipad_patch_sample(const void* fm0, const void* fm1,
                                  const void* fm2, const void* fm3, int H0,
                                  int H1, int H2, int H3, int W0, int W1,
                                  int W2, int W3, int nlev, int fm_bf16,
                                  const void* cam, const void* x,
                                  const void* y, const void* w,
                                  const void* lvl, int level_k, void* out,
                                  int bs, int cams, int C, int G, int M0,
                                  int cam_k, void* stream) {
  const int n = lvl != nullptr ? level_k : nlev;
  if (nlev < 1 || nlev > kMaxLevels || n < 1 || cam_k * n > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fms[kMaxLevels] = {fm0, fm1, fm2, fm3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fm_bf16)
    return launch<__nv_bfloat16>(fms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k, out, bs,
                                 cams, C, G, M0, cam_k, st);
  return launch<float>(fms, Hs, Ws, nlev, cam, x, y, w, lvl, level_k, out, bs, cams, C, G,
                       M0, cam_k, st);
}
