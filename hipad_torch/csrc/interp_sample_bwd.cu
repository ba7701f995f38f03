// K1-bwd: the adjoint of K1 (interp_sample.cu), coarse-level bilinear
// sampling summed over cameras.
//
// Replaces hipad_tpu/ops/sampling.py:_interp_matmul_tpu_bwd, the custom_vjp
// backward of the Pallas kernel, which replays the dense
// _interp_matmul_level under jax.vjp. With go = d out [bs, M, C] (the camera
// sum hands every camera the same upstream row) and, per (b, cam, m),
// hat weights wy_h = hat(py - h), wx_w = hat(px - w):
//
//   d fm[bc, h, w, c] += wy_h wx_w wg[bc, m, c/(C/G)] go[b, m, c]
//   d wg[bc, m, g]     = sum_{h,w} wy_h wx_w sum_{c in g} fm[bc, h, w, c] go[b, m, c]
//   d px[bc, m]        = sum_{h,w} wy_h hat'(px - w) sum_c wg fm go   (d py alike)
//
// hat' follows the JAX conventions at the kinks (sample_common.cuh), so a
// coordinate on an integer reaches three taps per axis, the outer two with
// weight 0 and derivative +-1/2, as the dense reference's iota compare does.
//
// What bounds it on this card: the fp32 atomics into d fm and the gathered
// rows (each (sample, camera) reads and scatters <= 4 rows of C channels;
// the 22x40 and 11x20 maps of levels 2-3 stay in the 50 MB L2). Design: one
// warp per (b, m) row as in the forward, the upstream row held in registers
// for all cameras, d wg / d px / d py reduced inside the warp and stored
// once, d fm by fp32 atomicAdd into a zeroed fp32 buffer (cast to the map's
// dtype by the caller). Samples whose taps all lie outside the map (points
// behind a camera project to ~1e8 px) are range-checked before any int
// conversion and get zero gradients.
#include "sample_common.cuh"

namespace {

using hipad::kMaxChunks;
using hipad::kThreads;
using hipad::kVec;
using hipad::kWarps;

template <typename T>
__global__ void __launch_bounds__(kThreads)
interp_sample_camsum_bwd_kernel(const T* __restrict__ fm,
                                const float* __restrict__ px,
                                const float* __restrict__ py,
                                const float* __restrict__ wg,
                                const float* __restrict__ gout,
                                float* __restrict__ dfm,
                                float* __restrict__ dpx,
                                float* __restrict__ dpy,
                                float* __restrict__ dwg, int bs, int cams,
                                int H, int W, int C, int G, int M) {
  __shared__ float red[kWarps][32 * kMaxChunks];
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(bs) * M) return;
  const int b = static_cast<int>(row / M);
  const int m = static_cast<int>(row - static_cast<long long>(b) * M);
  const int gd = C / G;

  float go[kMaxChunks][kVec];
  hipad::load_row(gout + row * C, go, C, lane);

  for (int cam = 0; cam < cams; ++cam) {
    const long long bc = static_cast<long long>(b) * cams + cam;
    const long long s = bc * M + m;
    const float* w = wg + s * G;
    const float x = px[s];
    const float y = py[s];
    float part[kMaxChunks] = {};
    float ax = 0.f, ay = 0.f;
    // taps floor(p)-1 .. floor(p)+1 reach the map only for p in [-1, size]
    // (also false for NaN)
    if (x >= -1.f && x <= static_cast<float>(W) && y >= -1.f &&
        y <= static_cast<float>(H)) {
      const int x0 = static_cast<int>(floorf(x));
      const int y0 = static_cast<int>(floorf(y));
      const T* img = fm + bc * H * W * C;
      float* dimg = dfm + bc * H * W * C;
      for (int yy = y0 - 1; yy <= y0 + 1; ++yy) {
        if (yy < 0 || yy >= H) continue;
        const float ty = y - static_cast<float>(yy);
        const float wy = hipad::hat(ty);
        const float dwy = hipad::hat_grad(ty);
        if (wy == 0.f && dwy == 0.f) continue;
        for (int xx = x0 - 1; xx <= x0 + 1; ++xx) {
          if (xx < 0 || xx >= W) continue;
          const float tx = x - static_cast<float>(xx);
          const float wx = hipad::hat(tx);
          const float dwx = hipad::hat_grad(tx);
          const float wxy = wy * wx;
          const float ddx = wy * dwx;
          const float ddy = dwy * wx;
          if (wxy == 0.f && ddx == 0.f && ddy == 0.f) continue;
          const long long off = (static_cast<long long>(yy) * W + xx) * C;
          float d = 0.f;
          hipad::tap_backward(img + off, dimg + off, go, w, wxy, part, d, C,
                              gd, lane);
          ax = fmaf(ddx, d, ax);
          ay = fmaf(ddy, d, ay);
        }
      }
    }
    ax = hipad::warp_sum(ax);
    ay = hipad::warp_sum(ay);
    if (lane == 0) {
      dpx[s] = ax;
      dpy[s] = ay;
    }
    hipad::store_group_sums(red[warp], part, dwg + s * G, C, G, lane);
  }
}

}  // namespace

// fm [bs*cams, H, W, C] (fp32, or bf16 when fm_bf16 != 0); px, py [bs*cams, M]
// fp32; wg [bs*cams, M, G] fp32; gout [bs, M, C] fp32. Outputs: dfm
// [bs*cams, H, W, C] fp32, zeroed by the caller; dpx, dpy [bs*cams, M] and
// dwg [bs*cams, M, G] fp32, every element written here.
// Returns cudaGetLastError() after the launch.
extern "C" int hipad_interp_sample_camsum_bwd(
    const void* fm, int fm_bf16, const void* px, const void* py,
    const void* wg, const void* gout, void* dfm, void* dpx, void* dpy,
    void* dwg, int bs, int cams, int H, int W, int C, int G, int M,
    void* stream) {
  const long long rows = static_cast<long long>(bs) * M;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_px = static_cast<const float*>(px);
  const float* f_py = static_cast<const float*>(py);
  const float* f_wg = static_cast<const float*>(wg);
  const float* f_go = static_cast<const float*>(gout);
  float* o_fm = static_cast<float*>(dfm);
  float* o_px = static_cast<float*>(dpx);
  float* o_py = static_cast<float*>(dpy);
  float* o_wg = static_cast<float*>(dwg);
  if (fm_bf16) {
    interp_sample_camsum_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(fm), f_px, f_py, f_wg, f_go, o_fm,
        o_px, o_py, o_wg, bs, cams, H, W, C, G, M);
  } else {
    interp_sample_camsum_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(fm), f_px, f_py, f_wg, f_go, o_fm, o_px,
        o_py, o_wg, bs, cams, H, W, C, G, M);
  }
  return static_cast<int>(cudaGetLastError());
}
