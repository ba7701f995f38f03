// K1: coarse-level bilinear sampling of every coarse level, summed over
// cameras and levels and added to the fine levels' sum, in one launch.
//
// Replaces hipad_tpu/ops/pallas_interp.py:interp_matmul_pallas (the Pallas
// dense-interp kernel), the camera sum that
// hipad_tpu/ops/sampling.py:interp_matmul_camsum applies to its output, and
// the coarse-level loop of deformable_samples_topk_flat around it (the
// per-level coordinates, the inside mask on the weights, the adds).
//
//   out[b, m, c] = acc[b, m, c] + sum_l sum_cam wg[b, m, cam, lvl_l, g(c)]
//                  * sum_{h,w} hat(py - h) hat(px - w) fm_l[b, cam, h, w, c]
//   px = x * W_l - 0.5, py = y * H_l - 0.5, hat(t) = max(0, 1 - |t|)
//   wg = weights * inside, inside: 0 < x < 1 and 0 < y < 1 (NaN: outside)
//
// The sums over levels are taken one level at a time, (acc + s_2) + s_3,
// each s_l over cameras and taps (camera, dy, dx) in order from zero: the
// adds of one launch per level followed by a torch add did the same.
//
// The TPU kernel builds the dense [T, H*W] interpolation tile in VMEM and
// feeds the matrix unit, because gathers on that chip are bound by per-row
// latency. Here the hat weights are zero everywhere but at <= 2x2 cells, so
// each (sample, camera, level) reads at most 4 NHWC rows of C channels. The
// dense form on the tensor cores loses by arithmetic: 2*6*11700*880*256 =
// 31.6 GFLOP at the det task's level 2, >= 32 us at 989 TFLOP/s, against
// ~11 us of bytes for both levels' gather.
//
// What bounds it on this card: the latency of the gathered rows, then their
// bytes (2 FLOPs per byte read). The maps of levels 2-3 (22x40 and 11x20 at
// C=256: 5.4 MB fp32 for 6 cameras) fit the 50 MB L2, but a sample reads
// about 15 rows of 1 KB from them, each a round trip, and a warp that reads
// one row, uses it and reads the next spends its time waiting. Design: one
// warp per (b, m) row. Its lanes load the row's cams x 2 coordinates and
// cams x levels x G weights together, one lane per (level, camera) pair
// computes the pair's inside mask, its taps' rows and bilinear weights; the
// live taps are listed in shared memory in sum order, then read in batches
// of 4 (C = 256) with every load of a batch in flight before its first FMA;
// fp32 registers, the acc row read once and the out row written once,
// 16-byte accesses. The coordinates round as the plain version's do (no
// fused multiply-add in x * W - 0.5).
#include "sample_common.cuh"

namespace {

using hipad::kFwdThreads;
using hipad::kFwdWarps;
using hipad::kVec;
using hipad::Tap;

constexpr int kMaxLevels = 4;

template <typename T>
struct CoarseLevels {
  const T* fm[kMaxLevels];  // [bs, cams, H, W, C] each
  int H[kMaxLevels];
  int W[kMaxLevels];
  int lvl[kMaxLevels];  // its index on the weights' level axis
  int n;
};

template <typename T, int NCH>
__global__ void __launch_bounds__(kFwdThreads)
coarse_sample_kernel(CoarseLevels<T> lv, const float* __restrict__ acc,
                     const float* __restrict__ pts, const void* __restrict__ wts,
                     int w_bf16, float* __restrict__ out, int bs, int M0, int cams,
                     int L, int C, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pairs = lv.n * cams;  // pair p = (level p / cams, camera p % cams)
  unsigned char* mine = smem + warp * hipad::warp_smem_bytes(pairs, G);
  Tap<T>* list = reinterpret_cast<Tap<T>*>(mine);
  float* wg = reinterpret_cast<float*>(mine + pairs * 4 * sizeof(Tap<T>));
  const int li = lane / cams;
  const int cam = lane - li * cams;
  const long long row = static_cast<long long>(blockIdx.x) * kFwdWarps + warp;
  if (row >= static_cast<long long>(bs) * M0) return;
  const int b = static_cast<int>(row / M0);

  // the acc row, this pair's coordinates and the row's coarse weights, all
  // loads issued together
  float tot[NCH][kVec];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int c0 = (ch * 32 + lane) * kVec;
    if (acc != nullptr && c0 < C) {
      const float4* a = reinterpret_cast<const float4*>(acc + row * C + c0);
      const float4 u = __ldg(a), v = __ldg(a + 1);
      tot[ch][0] = u.x; tot[ch][1] = u.y; tot[ch][2] = u.z; tot[ch][3] = u.w;
      tot[ch][4] = v.x; tot[ch][5] = v.y; tot[ch][6] = v.z; tot[ch][7] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) tot[ch][i] = 0.f;
    }
  }
  float2 xy = make_float2(0.f, 0.f);
  if (lane < pairs) xy = __ldg(reinterpret_cast<const float2*>(pts) + row * cams + cam);
  const long long wrow = row * cams * L * G;  // weights [bs, M0, cams, L, G]
  for (int i = lane; i < pairs * G; i += 32) {
    const int p = i / G;
    const int l = p / cams;
    int lvl = lv.lvl[0];
#pragma unroll
    for (int j = 1; j < kMaxLevels; ++j) lvl = j == l ? lv.lvl[j] : lvl;
    const long long at = wrow + (static_cast<long long>(p - l * cams) * L + lvl) * G + (i - p * G);
    wg[i] = w_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(wts) + at))
                   : __ldg(static_cast<const float*>(wts) + at);
  }
  __syncwarp();

  // this lane's pair: live when inside with a non-zero group weight; its
  // taps are the cells of the 2x2 footprint inside the map with a non-zero
  // hat weight
  Tap<T> tap[4];
  unsigned mask = 0;
  const bool inside = xy.x > 0.f && xy.x < 1.f && xy.y > 0.f && xy.y < 1.f;
  if (lane < pairs && inside) {
    bool any = false;
    for (int g = 0; g < G; ++g) any |= wg[lane * G + g] != 0.f;
    if (any) {
      // the pair's level by constant indices: a dynamic index into the
      // kernel's parameters would copy them to local memory
      const T* fm = lv.fm[0];
      int H = lv.H[0], W = lv.W[0];
#pragma unroll
      for (int l = 1; l < kMaxLevels; ++l) {
        if (l == li) {
          fm = lv.fm[l];
          H = lv.H[l];
          W = lv.W[l];
        }
      }
      const float px = __fmul_rn(xy.x, static_cast<float>(W)) - 0.5f;
      const float py = __fmul_rn(xy.y, static_cast<float>(H)) - 0.5f;
      const int x0 = static_cast<int>(floorf(px));
      const int y0 = static_cast<int>(floorf(py));
      const T* img = fm + (static_cast<long long>(b) * cams + cam) * H * W * C;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int yy = y0 + (k >> 1);
        const int xx = x0 + (k & 1);
        const float w = hipad::hat(py - static_cast<float>(yy)) *
                        hipad::hat(px - static_cast<float>(xx));
        tap[k] = Tap<T>{img + (static_cast<long long>(yy) * W + xx) * C, w, lane};
        if (yy >= 0 && yy < H && xx >= 0 && xx < W && w != 0.f) mask |= 1u << k;
      }
    }
  }
  const int n = hipad::list_taps(list, tap, mask, lane);

  hipad::sum_taps<T, NCH, hipad::batch_taps<NCH>()>(list, n, wg, cams, C, G, lane, tot);
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
void launch(const CoarseLevels<T>& lv, const void* acc, const void* pts, const void* w,
            int w_bf16, void* out, int bs, int M0, int cams, int L, int C, int G,
            cudaStream_t st) {
  const int smem = kFwdWarps * hipad::warp_smem_bytes(lv.n * cams, G);
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(bs) * M0 + kFwdWarps - 1) / kFwdWarps);
  coarse_sample_kernel<T, NCH><<<blocks, kFwdThreads, smem, st>>>(
      lv, static_cast<const float*>(acc), static_cast<const float*>(pts), w, w_bf16,
      static_cast<float*>(out), bs, M0, cams, L, C, G);
}

template <typename T>
int dispatch(const void* const* fms, const int* Hs, const int* Ws, const int* lvls, int nlev,
             const void* acc, const void* pts, const void* w, int w_bf16, void* out, int bs,
             int M0, int cams, int L, int C, int G, cudaStream_t st) {
  CoarseLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.fm[l] = static_cast<const T*>(fms[l]);
    lv.H[l] = Hs[l];
    lv.W[l] = Ws[l];
    lv.lvl[l] = lvls[l];
  }
  lv.n = nlev;
  switch ((C + 255) / 256) {
    case 1: launch<T, 1>(lv, acc, pts, w, w_bf16, out, bs, M0, cams, L, C, G, st); break;
    case 2: launch<T, 2>(lv, acc, pts, w, w_bf16, out, bs, M0, cams, L, C, G, st); break;
    case 3: launch<T, 3>(lv, acc, pts, w, w_bf16, out, bs, M0, cams, L, C, G, st); break;
    case 4: launch<T, 4>(lv, acc, pts, w, w_bf16, out, bs, M0, cams, L, C, G, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fm0..fm3: coarse maps [bs, cams, H_l, W_l, C] (fp32, or bf16 when
// fm_bf16 != 0), the first nlev used, level l at index lvl_l of the
// weights' level axis; acc [bs, M0, C] fp32 or null; pts [bs, M0, cams, 2]
// fp32 normalised (x, y); w [bs, M0, cams, L, G] (fp32, or bf16 when
// w_bf16 != 0); out [bs, M0, C] fp32. Needs nlev * cams <= 32, C <= 1024,
// (C / G) % 8 == 0 and kFwdWarps * warp_smem_bytes(nlev * cams, G) <= 48 KB
// (the wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int hipad_coarse_sample(const void* fm0, const void* fm1, const void* fm2,
                                   const void* fm3, int H0, int H1, int H2, int H3, int W0,
                                   int W1, int W2, int W3, int lvl0, int lvl1, int lvl2,
                                   int lvl3, int nlev, int fm_bf16, const void* acc,
                                   const void* pts, const void* w, int w_bf16, void* out,
                                   int bs, int M0, int cams, int L, int C, int G,
                                   void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || nlev * cams > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fms[kMaxLevels] = {fm0, fm1, fm2, fm3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  const int lvls[kMaxLevels] = {lvl0, lvl1, lvl2, lvl3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fm_bf16)
    return dispatch<__nv_bfloat16>(fms, Hs, Ws, lvls, nlev, acc, pts, w, w_bf16, out, bs, M0,
                                   cams, L, C, G, st);
  return dispatch<float>(fms, Hs, Ws, lvls, nlev, acc, pts, w, w_bf16, out, bs, M0, cams, L,
                         C, G, st);
}
