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
// What bounds it on this card: the scatter into d fm. Some 11,700 samples x
// 6 cameras add into maps of only 22x40 and 11x20 cells, some 50 taps per
// cell, which atomics in device memory would serialise in the L2 and whose
// order of addition they would leave to the schedule. Design: one C call,
// five launches on the caller's stream, every element of every output
// written once, in an order of addition that the inputs alone fix (the same
// bits on every run, as torch's deterministic flag asks):
//
//  * Sample blocks, one warp per (b, m) row as in the forward, the upstream
//    row in registers for the 6 cameras, whose coordinates the warp reads at
//    once: read the rows of the four taps (y0 + i, x0 + j) at once (and of
//    the kinks' outer taps after them), reduce d wg, d px, d py inside the
//    warp and store each once. They do not touch d fm; they write one item
//    per (sample, camera) whose taps reach the map with a non-zero weight,
//    binned by (camera's map, top tap row, segment of the left tap column),
//    and count the bins.
//  * The binned scatter of bin_scatter.cuh: a stable counting sort of the
//    items by bin (two scan launches, a place launch), then a warp per map cell
//    (per run of 4 on maps whose cells get few taps), lanes on channels, that
//    sums the taps of its cells in the items' order in fp32 registers and
//    writes each cell once in the map's dtype (ops/kernels.py: k1_bwd_plan).
//    Maps of any size take the same path.
//
// Samples whose taps all lie outside the map (points behind a camera
// project to ~1e8 px) are range-checked before any int conversion, in both
// kernels.
#include "bin_scatter.cuh"
#include "sample_common.cuh"

namespace {

using hipad::kMaxChunks;
using hipad::kThreads;
using hipad::kVec;
using hipad::kWarps;

// d px, d py and d wg of one (sample, camera) from one tap (yy, xx) whose row
// is v, taking the hat weights and derivatives at the tap.
template <int NCH>
__device__ __forceinline__ void sample_tap(const float (&v)[NCH][kVec],
                                           const float (&go)[NCH][kVec],
                                           const float* w, float x, float y,
                                           int yy, int xx, float (&part)[NCH],
                                           float& ax, float& ay, int C, int gd,
                                           int lane) {
  const float ty = y - static_cast<float>(yy);
  const float tx = x - static_cast<float>(xx);
  const float wy = hipad::hat(ty);
  const float wx = hipad::hat(tx);
  const float wxy = wy * wx;
  const float ddx = wy * hipad::hat_grad(tx);
  const float ddy = hipad::hat_grad(ty) * wx;
  if (wxy == 0.f && ddx == 0.f && ddy == 0.f) return;
  float d = 0.f;
  hipad::tap_backward(v, go, w, wxy, part, d, C, gd, lane);
  ax = fmaf(ddx, d, ax);
  ay = fmaf(ddy, d, ay);
}

// NCH = ceil(C / 256) chunks of 8 channels per lane.
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
interp_sample_camsum_bwd_samples_kernel(const T* __restrict__ fm,
                                        const float* __restrict__ px,
                                        const float* __restrict__ py,
                                        const float* __restrict__ wg,
                                        const float* __restrict__ gout,
                                        float* __restrict__ dpx,
                                        float* __restrict__ dpy,
                                        float* __restrict__ dwg, int bs,
                                        int cams, int H, int W, int C, int G,
                                        int M, hipad::BinScratch bins, int chunks,
                                        int nseg, int sw) {
  __shared__ float red[kWarps][32 * kMaxChunks];
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(bs) * M) return;
  const int b = static_cast<int>(row / M);
  const int m = static_cast<int>(row - static_cast<long long>(b) * M);
  const int gd = C / G;

  float go[NCH][kVec];
  hipad::load_row(gout + row * C, go, C, lane);

  float xl = 0.f, yl = 0.f;  // lane l holds camera (32 * k + l)'s coordinates
  for (int cam = 0; cam < cams; ++cam) {
    const long long bc = static_cast<long long>(b) * cams + cam;
    const long long s = bc * M + m;
    if ((cam & 31) == 0 && cam + lane < cams) {
      xl = px[s + static_cast<long long>(lane) * M];
      yl = py[s + static_cast<long long>(lane) * M];
    }
    const float x = __shfl_sync(0xffffffffu, xl, cam & 31);
    const float y = __shfl_sync(0xffffffffu, yl, cam & 31);
    const float* w = wg + s * G;
    float part[NCH] = {};
    float ax = 0.f, ay = 0.f;
    // taps floor(p)-1 .. floor(p)+1 reach the map only for p in [-1, size]
    // (also false for NaN)
    if (x >= -1.f && x <= static_cast<float>(W) && y >= -1.f &&
        y <= static_cast<float>(H)) {
      const int x0 = static_cast<int>(floorf(x));
      const int y0 = static_cast<int>(floorf(y));
      const T* img = fm + bc * H * W * C;
      // the taps (y0 + i, x0 + j), i, j in {0, 1}: their four rows are read
      // at once, then used
      float v[2][2][NCH][kVec];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int yy = y0 + i, xx = x0 + j;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            hipad::load_row(img + (static_cast<long long>(yy) * W + xx) * C, v[i][j], C, lane);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int yy = y0 + i, xx = x0 + j;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            sample_tap(v[i][j], go, w, x, y, yy, xx, part, ax, ay, C, gd, lane);
          }
        }
      }
      // on a kink (a coordinate on an integer) the taps y0 - 1 and x0 - 1
      // have weight 0 and a hat derivative of +-1/2
      if (x == static_cast<float>(x0) || y == static_cast<float>(y0)) {
        for (int yy = y0 - 1; yy <= y0 + 1; ++yy) {
          for (int xx = x0 - 1; xx <= x0 + 1; ++xx) {
            if ((yy >= y0 && xx >= x0) || yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
            float u[NCH][kVec];
            hipad::load_row(img + (static_cast<long long>(yy) * W + xx) * C, u, C, lane);
            sample_tap(u, go, w, x, y, yy, xx, part, ax, ay, C, gd, lane);
          }
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
  // the items, one per camera of the row: those whose taps can reach the
  // map with a non-zero weight, binned by (camera's map, top tap row,
  // segment of the left tap column)
  for (int cam = lane; cam < cams; cam += 32) {
    const long long bc = static_cast<long long>(b) * cams + cam;
    const long long s = bc * M + m;
    const float x = px[s];
    const float y = py[s];
    bool any = false;
#pragma unroll 8
    for (int q = 0; q < G; ++q) any |= wg[s * G + q] != 0.f;
    int key = -1;
    if (any && x > -1.f && x < static_cast<float>(W) && y > -1.f && y < static_cast<float>(H)) {
      const int col = max(static_cast<int>(floorf(x)), 0);
      key = static_cast<int>((bc * (H + 1) + static_cast<int>(floorf(y)) + 1) * nseg + col / sw);
    }
    hipad::bin_item(bins.keys, bins.items, bins.hist, chunks, s, key, x, y, static_cast<int>(s),
                    static_cast<int>(row));
  }
}

template <typename T>
cudaError_t launch(const void* fm, const float* px, const float* py, const float* wg,
                   const float* gout, void* dfm, float* dpx, float* dpy, float* dwg, int bs,
                   int cams, int H, int W, int C, int G, int M, const hipad::BinScratch& bins,
                   const hipad::BinPlan& plan, cudaStream_t st) {
  cudaError_t err = hipad::bin_begin(bins, plan, st);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(bs) * M;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  auto* samples = interp_sample_camsum_bwd_samples_kernel<T, kMaxChunks>;
  switch ((C + 32 * kVec - 1) / (32 * kVec)) {
    case 1: samples = interp_sample_camsum_bwd_samples_kernel<T, 1>; break;
    case 2: samples = interp_sample_camsum_bwd_samples_kernel<T, 2>; break;
    case 3: samples = interp_sample_camsum_bwd_samples_kernel<T, 3>; break;
  }
  const int sw = plan.sw[0];
  samples<<<blocks, kThreads, 0, st>>>(static_cast<const T*>(fm), px, py, wg, gout, dpx, dpy,
                                       dwg, bs, cams, H, W, C, G, M, bins, plan.chunks,
                                       (W + sw - 1) / sw, sw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  T* dfms[1] = {static_cast<T*>(dfm)};
  return hipad::bin_finish<T>(bins, plan, rows * cams, dfms, &H, &W, hipad::K1Geo{}, gout, wg,
                              C, G, st);
}

}  // namespace

// fm [bs*cams, H, W, C] (fp32, or bf16 when fm_bf16 != 0); px, py [bs*cams, M]
// fp32; wg [bs*cams, M, G] fp32; gout [bs, M, C] fp32. Outputs: dfm
// [bs*cams, H, W, C] in fm's dtype; dpx, dpy [bs*cams, M] and dwg
// [bs*cams, M, G] fp32; every element of each written here. keys, items,
// hist, tot, out, start: the scratch of hipad::BinScratch; plan: the host
// ints of ops/kernels.py:k1_bwd_plan (one level, tb0 = -1: bin rows are the
// top tap rows -1 .. H-1). Returns the first CUDA error of the six
// launches (the counts' zero fill, the sample blocks, the two scans, the
// placement, the cells), or 0.
extern "C" int hipad_interp_sample_camsum_bwd(
    const void* fm, int fm_bf16, const void* px, const void* py, const void* wg,
    const void* gout, void* dfm, void* dpx, void* dpy, void* dwg, int bs, int cams, int H,
    int W, int C, int G, int M, void* keys, void* items, void* hist, void* tot, void* out,
    void* start, const int* plan, void* stream) {
  hipad::BinPlan p;
  if (!hipad::read_plan(plan, p) || p.n != 1 || p.tb0[0] != -1 || p.rowbins[0] != H + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const hipad::BinScratch bins{static_cast<int*>(keys), static_cast<hipad::BinItem*>(items),
                               static_cast<int*>(hist), static_cast<int*>(tot),
                               static_cast<hipad::BinItem*>(out), static_cast<int*>(start)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_px = static_cast<const float*>(px);
  const float* f_py = static_cast<const float*>(py);
  const float* f_wg = static_cast<const float*>(wg);
  const float* f_go = static_cast<const float*>(gout);
  float* o_px = static_cast<float*>(dpx);
  float* o_py = static_cast<float*>(dpy);
  float* o_wg = static_cast<float*>(dwg);
  const cudaError_t err =
      fm_bf16 ? launch<__nv_bfloat16>(fm, f_px, f_py, f_wg, f_go, dfm, o_px, o_py, o_wg, bs,
                                      cams, H, W, C, G, M, bins, p, st)
              : launch<float>(fm, f_px, f_py, f_wg, f_go, dfm, o_px, o_py, o_wg, bs, cams, H,
                              W, C, G, M, bins, p, st);
  return static_cast<int>(err);
}
