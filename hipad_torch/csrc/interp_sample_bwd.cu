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
// 6 cameras add into maps of only 22x40 and 11x20 cells, some 20 to 85 adds
// per address, which atomics in device memory would serialise in the L2.
// Design: one C call, two launches on the caller's stream, each about half
// of the time, both bound by the latency of their warps' dependent reads.
//
//  * Sample blocks, one warp per (b, m) row as in the forward, the upstream
//    row in registers for the 6 cameras, whose coordinates the warp reads at
//    once: read the rows of the four taps (y0 + i, x0 + j) at once (and of
//    the kinks' outer taps after them), reduce d wg, d px, d py inside the
//    warp and store each once. They do not touch d fm.
//  * Tile blocks: a cluster of S blocks owns one tile d fm[bc, :, :, c0:c0+Ct]
//    (Ct channels of one group), each block a copy in shared memory. The
//    blocks zero their copies, split the samples of batch b among their
//    warps, and add wxy * wg * go of every tap with a non-zero weight into
//    their copy by shared-memory atomics, lane = channel on consecutive words.
//    Then each block sums one S-th of the tile over the cluster's copies
//    (distributed shared memory) and writes it once, in the map's dtype.
//
// So every element of d fm is written exactly once, and the caller needs no
// zero fill. The tile size (Ct, S, bytes) is chosen by the caller
// (ops/kernels.py: k1_bwd_tiling). A map whose fp32 tile does not fit one
// block's shared memory even at 8 channels (more than 7,264 cells) is cut
// into bands of Hb whole rows, Hb = bytes / (W * Ct * 4): each band is a
// tile of its own, whose blocks read every sample but keep only the taps
// whose row lies in the band (a sample's two tap rows may straddle two
// bands, each adding its own). Samples whose taps all lie outside the
// map (points behind a camera project to ~1e8 px) are range-checked before
// any int conversion, in both kinds of block.
#include <cooperative_groups.h>

#include "sample_common.cuh"

namespace cg = cooperative_groups;

namespace {

using hipad::kMaxChunks;
using hipad::kThreads;
using hipad::kVec;
using hipad::kWarps;

constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kMaxTile = 32;    // channels of a tile: one lane each
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kBatch = 4;       // live samples a warp takes at once

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
                                        int M) {
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
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// grid (S, C / Ct * bands, bs*cams), cluster (S, 1, 1), kTileThreads
// threads, Hb*W*Ct floats of dynamic shared memory: the copy of this block
// of its band of rows [r0, r0 + Hb) (the last band may be shorter).
template <typename T>
__global__ void __launch_bounds__(kTileThreads, 2)
interp_sample_camsum_bwd_tiles_kernel(const float* __restrict__ px,
                                      const float* __restrict__ py,
                                      const float* __restrict__ wg,
                                      const float* __restrict__ gout,
                                      T* __restrict__ dfm, int cams, int H,
                                      int W, int C, int G, int M, int Ct,
                                      int Hb) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bands = (H + Hb - 1) / Hb;
  const int c0 = (blockIdx.y / bands) * Ct;
  const int r0 = (blockIdx.y % bands) * Hb;  // the band's rows [r0, r1)
  const int r1 = min(H, r0 + Hb);
  const long long bc = blockIdx.z;
  const long long b = bc / cams;
  const int n4 = (r1 - r0) * W * Ct / 4;

  // 1. zero this block's copy
  for (int i = threadIdx.x; i < n4; i += kTileThreads) tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // 2. scatter: lane l looks at sample m (its coordinates read a round
  // ahead), then the warp adds each live sample's taps, kBatch samples at a
  // time, lane = channel (lanes >= Ct idle)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool chan = lane < Ct;
  const float* pxb = px + bc * M;
  const float* pyb = py + bc * M;
  const float* wgb = wg + bc * M * G + c0 / (C / G);  // the tile's group
  const float* gob = gout + b * M * C + c0 + (chan ? lane : 0);
  const int stride = S * kTileWarps * 32;
  int m = (rank * kTileWarps + warp) * 32 + lane;
  float xn = 0.f, yn = 0.f, wn = 0.f;  // sample m's, read one round ahead
  if (m < M) {
    xn = pxb[m];
    yn = pyb[m];
    wn = wgb[static_cast<long long>(m) * G];
  }
  for (; m - lane < M; m += stride) {
    const float x = xn, y = yn, w = wn;
    if (m + stride < M) {
      xn = pxb[m + stride];
      yn = pyb[m + stride];
      wn = wgb[static_cast<long long>(m + stride) * G];
    }
    int x0 = 0, y0 = 0;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    if (m < M) {
      // a tap with a non-zero hat weight lies on the map only for p in
      // (-1, size), and in the band only for y in (r0 - 1, r1) (also false
      // for NaN)
      if (w != 0.f && x > -1.f && x < static_cast<float>(W) &&
          y > static_cast<float>(r0 - 1) && y < static_cast<float>(r1)) {
        x0 = static_cast<int>(floorf(x));
        y0 = static_cast<int>(floorf(y));
        const float wx0 = x0 >= 0 ? hipad::hat(x - static_cast<float>(x0)) : 0.f;
        const float wx1 = x0 + 1 < W ? hipad::hat(x - static_cast<float>(x0 + 1)) : 0.f;
        const float wy0 = y0 >= r0 ? hipad::hat(y - static_cast<float>(y0)) : 0.f;
        const float wy1 = y0 + 1 < r1 ? hipad::hat(y - static_cast<float>(y0 + 1)) : 0.f;
        s00 = wy0 * wx0 * w;
        s01 = wy0 * wx1 * w;
        s10 = wy1 * wx0 * w;
        s11 = wy1 * wx1 * w;
      }
    }
    unsigned live = __ballot_sync(0xffffffffu,
                                  s00 != 0.f || s01 != 0.f || s10 != 0.f || s11 != 0.f);
    while (live != 0u) {
      int src[kBatch];
      float g[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        src[k] = live != 0u ? __ffs(live) - 1 : -1;
        live &= live - 1u;
        const int ms = __shfl_sync(0xffffffffu, m, src[k] < 0 ? 0 : src[k]);
        g[k] = src[k] >= 0 && chan ? __ldg(gob + static_cast<long long>(ms) * C) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int sl = src[k] < 0 ? 0 : src[k];
        // the tap's cell in the band; negative for y0 = r0 - 1, whose row-y0
        // taps then have weight 0
        const int cell = __shfl_sync(0xffffffffu, (y0 - r0) * W + x0, sl);
        const float a00 = __shfl_sync(0xffffffffu, s00, sl);
        const float a01 = __shfl_sync(0xffffffffu, s01, sl);
        const float a10 = __shfl_sync(0xffffffffu, s10, sl);
        const float a11 = __shfl_sync(0xffffffffu, s11, sl);
        if (src[k] >= 0 && chan) {
          // a zero weight marks a tap outside the map: never dereferenced
          if (a00 != 0.f) atomicAdd(tile + cell * Ct + lane, a00 * g[k]);
          if (a01 != 0.f) atomicAdd(tile + (cell + 1) * Ct + lane, a01 * g[k]);
          if (a10 != 0.f) atomicAdd(tile + (cell + W) * Ct + lane, a10 * g[k]);
          if (a11 != 0.f) atomicAdd(tile + (cell + W + 1) * Ct + lane, a11 * g[k]);
        }
      }
    }
  }

  // 3.-4. sum one S-th of the tile over the cluster's copies and write it
  cluster.sync();
  const int per = (n4 + S - 1) / S;
  const int hi = min(n4, (rank + 1) * per);
  const int ct4 = Ct / 4;
  for (int i = rank * per + threadIdx.x; i < hi; i += kTileThreads) {
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < S) v[q] = cluster.map_shared_rank(tile4, q)[i];
    }
    float4 acc = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < S) {
        acc.x += v[q].x;
        acc.y += v[q].y;
        acc.z += v[q].z;
        acc.w += v[q].w;
      }
    }
    const int cell = i / ct4;
    const int c = (i - cell * ct4) * 4;
    store4(dfm + (bc * H * W + static_cast<long long>(r0) * W + cell) * C + c0 + c, acc);
  }
  cluster.sync();  // no block leaves while another reads its copy
}

template <typename T>
cudaError_t launch(const void* fm, const float* px, const float* py,
                   const float* wg, const float* gout, void* dfm, float* dpx,
                   float* dpy, float* dwg, int bs, int cams, int H, int W,
                   int C, int G, int M, int Ct, int S, int smem,
                   cudaStream_t st) {
  const long long rows = static_cast<long long>(bs) * M;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  auto* samples = interp_sample_camsum_bwd_samples_kernel<T, kMaxChunks>;
  switch ((C + 32 * kVec - 1) / (32 * kVec)) {
    case 1: samples = interp_sample_camsum_bwd_samples_kernel<T, 1>; break;
    case 2: samples = interp_sample_camsum_bwd_samples_kernel<T, 2>; break;
    case 3: samples = interp_sample_camsum_bwd_samples_kernel<T, 3>; break;
  }
  samples<<<blocks, kThreads, 0, st>>>(static_cast<const T*>(fm), px, py, wg, gout, dpx,
                                       dpy, dwg, bs, cams, H, W, C, G, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* tiles = interp_sample_camsum_bwd_tiles_kernel<T>;
  err = cudaFuncSetAttribute(tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  const int Hb = smem / (W * Ct * 4);
  cfg.gridDim = dim3(S, C / Ct * ((H + Hb - 1) / Hb), bs * cams);
  cfg.blockDim = dim3(kTileThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tiles, px, py, wg, gout, static_cast<T*>(dfm), cams, H, W,
                            C, G, M, Ct, Hb);
}

}  // namespace

// fm [bs*cams, H, W, C] (fp32, or bf16 when fm_bf16 != 0); px, py [bs*cams, M]
// fp32; wg [bs*cams, M, G] fp32; gout [bs, M, C] fp32. Outputs: dfm
// [bs*cams, H, W, C] in fm's dtype; dpx, dpy [bs*cams, M] and dwg
// [bs*cams, M, G] fp32; every element of each written here. Tiling: Ct
// channels per tile (8, 16 or 32, dividing C/G), clusters of S <= 8 blocks,
// smem = Hb*W*Ct*4 bytes of shared memory per block for bands of Hb rows
// (Hb = H: the whole map in one tile).
// Returns the first CUDA error of the two launches, or 0.
extern "C" int hipad_interp_sample_camsum_bwd(
    const void* fm, int fm_bf16, const void* px, const void* py,
    const void* wg, const void* gout, void* dfm, void* dpx, void* dpy,
    void* dwg, int bs, int cams, int H, int W, int C, int G, int M, int Ct,
    int S, int smem, void* stream) {
  if (Ct < 8 || Ct > kMaxTile || Ct % 8 != 0 || (C / G) % Ct != 0 || S < 1 ||
      S > kMaxCluster || smem <= 0 || smem % (4 * W * Ct) != 0 ||
      smem / (4 * W * Ct) > H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
                                      cams, H, W, C, G, M, Ct, S, smem, st)
              : launch<float>(fm, f_px, f_py, f_wg, f_go, dfm, o_px, o_py, o_wg, bs, cams, H,
                              W, C, G, M, Ct, S, smem, st);
  return static_cast<int>(err);
}
