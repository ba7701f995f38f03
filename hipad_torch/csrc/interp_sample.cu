// K1: coarse-level bilinear sampling, summed over cameras.
//
// Replaces hipad_tpu/ops/pallas_interp.py:interp_matmul_pallas (the Pallas
// dense-interp kernel) together with the camera sum that
// hipad_tpu/ops/sampling.py:interp_matmul_camsum applies to its output.
//
//   out[b, m, c] = sum_cam wg[b*cams+cam, m, c/(C/G)]
//                  * sum_{h,w} hat(py - h) hat(px - w) fm[b*cams+cam, h, w, c]
//   hat(t) = max(0, 1 - |t|)
//
// The TPU kernel builds the dense [T, H*W] interpolation tile in VMEM and
// feeds the matrix unit, because gathers on that chip are bound by per-row
// latency. The hat weights are zero everywhere but at <= 2x2 cells, so here
// each (sample, camera) reads at most 4 NHWC rows of C channels.
//
// What bounds it on this card: gathered bytes, not FLOPs (2 FLOPs per byte
// read). Per (sample, camera) at most 4 rows of C*sizeof(T) bytes; the maps
// of levels 2-3 (22x40 and 11x20 at C=256: 5.4 MB fp32 for 6 cameras) stay
// in the 50 MB L2, so the reads are L2 hits. Design: one warp per output
// row, 16-byte coalesced loads, fp32 register accumulation, one write;
// samples whose group weights are all zero (out of bounds, masked by the
// caller) and corners out of the map skip their loads.
#include "sample_common.cuh"

namespace {

using hipad::kMaxChunks;
using hipad::kThreads;
using hipad::kVec;
using hipad::kWarps;

template <typename T>
__global__ void __launch_bounds__(kThreads)
interp_sample_camsum_kernel(const T* __restrict__ fm,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            const float* __restrict__ wg,
                            float* __restrict__ out, int bs, int cams, int H,
                            int W, int C, int G, int M) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(bs) * M) return;
  const int b = static_cast<int>(row / M);
  const int m = static_cast<int>(row - static_cast<long long>(b) * M);
  const int gd = C / G;

  float acc[kMaxChunks][kVec];
  hipad::zero_acc(acc);
  for (int cam = 0; cam < cams; ++cam) {
    const long long bc = static_cast<long long>(b) * cams + cam;
    const long long s = bc * M + m;
    const float* w = wg + s * G;
    if (!hipad::any_nonzero(w, G)) continue;
    const float x = px[s];
    const float y = py[s];
    // no corner of the 2x2 footprint lies inside the map (also drops NaN)
    if (!(x > -1.f && x < static_cast<float>(W) && y > -1.f &&
          y < static_cast<float>(H)))
      continue;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const int x0 = static_cast<int>(x0f);
    const int y0 = static_cast<int>(y0f);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const T* img = fm + bc * H * W * C;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yy = y0 + dy;
      if (yy < 0 || yy >= H) continue;
      const float wy = dy ? fy : 1.f - fy;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xx = x0 + dx;
        if (xx < 0 || xx >= W) continue;
        const float wxy = wy * (dx ? fx : 1.f - fx);
        if (wxy == 0.f) continue;
        hipad::accumulate_row(
            acc, img + (static_cast<long long>(yy) * W + xx) * C, w, wxy, C,
            gd, lane);
      }
    }
  }
  hipad::store_row(out + row * C, acc, C, lane);
}

}  // namespace

// fm [bs*cams, H, W, C] (fp32, or bf16 when fm_bf16 != 0); px, py [bs*cams, M]
// fp32 pixel coordinates; wg [bs*cams, M, G] fp32; out [bs, M, C] fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int hipad_interp_sample_camsum(const void* fm, int fm_bf16,
                                          const void* px, const void* py,
                                          const void* wg, void* out, int bs,
                                          int cams, int H, int W, int C, int G,
                                          int M, void* stream) {
  const long long rows = static_cast<long long>(bs) * M;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fm_bf16) {
    interp_sample_camsum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(fm), static_cast<const float*>(px),
        static_cast<const float*>(py), static_cast<const float*>(wg),
        static_cast<float*>(out), bs, cams, H, W, C, G, M);
  } else {
    interp_sample_camsum_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(fm), static_cast<const float*>(px),
        static_cast<const float*>(py), static_cast<const float*>(wg),
        static_cast<float*>(out), bs, cams, H, W, C, G, M);
  }
  return static_cast<int>(cudaGetLastError());
}
