// Shared pieces of the sampler kernels (interp_sample.cu, patch_sample.cu and
// their backward kernels interp_sample_bwd.cu, patch_sample_bwd.cu).
//
// Layout: one warp owns one output row [C] of one (batch, sample). Lane l
// reads channels [8*(l + 32*j), 8*(l + 32*j) + 8) of every NHWC feature row
// it touches: 16-byte loads (bf16) or two 16-byte loads (fp32), neighbouring
// lanes on neighbouring addresses, so one warp reads a whole 256-channel row
// in one coalesced sweep. The sum stays in fp32 registers and is written once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hipad {

constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;              // channels per lane per chunk
constexpr int kMaxChunks = 4;        // C <= 32 * kVec * kMaxChunks = 1024

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// True when any of the G group weights is non-zero: samples the caller
// masked out (out of bounds, or a camera not kept) skip their loads.
__device__ __forceinline__ bool any_nonzero(const float* w, int G) {
  for (int g = 0; g < G; ++g) {
    if (w[g] != 0.f) return true;
  }
  return false;
}

__device__ __forceinline__ void zero_acc(float (&acc)[kMaxChunks][kVec]) {
#pragma unroll
  for (int ch = 0; ch < kMaxChunks; ++ch) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[ch][i] = 0.f;
  }
}

// acc += wxy * wg[group(c)] * row[c] over this lane's channels.
// Requires (C / G) % kVec == 0, so that each 8-channel chunk lies in one group.
template <typename T>
__device__ __forceinline__ void accumulate_row(float (&acc)[kMaxChunks][kVec],
                                               const T* row, const float* wg,
                                               float wxy, int C, int gd,
                                               int lane) {
#pragma unroll
  for (int ch = 0; ch < kMaxChunks; ++ch) {
    const int c0 = (ch * 32 + lane) * kVec;
    if (c0 < C) {
      float v[kVec];
      load8(row + c0, v);
      const float s = wxy * wg[c0 / gd];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[ch][i] = fmaf(s, v[i], acc[ch][i]);
    }
  }
}

__device__ __forceinline__ void store_row(float* out,
                                          const float (&acc)[kMaxChunks][kVec],
                                          int C, int lane) {
#pragma unroll
  for (int ch = 0; ch < kMaxChunks; ++ch) {
    const int c0 = (ch * 32 + lane) * kVec;
    if (c0 < C) {
      float4* o = reinterpret_cast<float4*>(out + c0);
      o[0] = make_float4(acc[ch][0], acc[ch][1], acc[ch][2], acc[ch][3]);
      o[1] = make_float4(acc[ch][4], acc[ch][5], acc[ch][6], acc[ch][7]);
    }
  }
}

// ---- pieces of the two backward kernels --------------------------------

// The bilinear hat weight max(0, 1 - |t|) and its derivative in t, with the
// JAX package's conventions at the kinks (its adjoints are the reference):
// d|t|/dt = 1 at t = 0, and max(0, u) passes half the gradient at u = 0.
__device__ __forceinline__ float hat(float t) { return fmaxf(0.f, 1.f - fabsf(t)); }

__device__ __forceinline__ float hat_grad(float t) {
  const float u = 1.f - fabsf(t);
  const float s = u > 0.f ? 1.f : (u == 0.f ? 0.5f : 0.f);
  return t >= 0.f ? -s : s;
}

// One NHWC row into registers: this lane's 8-channel chunks, NCH of them
// (C <= 256 * NCH).
template <typename T, int NCH>
__device__ __forceinline__ void load_row(const T* p, float (&g)[NCH][kVec], int C, int lane) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int c0 = (ch * 32 + lane) * kVec;
    if (c0 < C) load8(p + c0, g[ch]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One tap of the backward: v is one NHWC feature row in registers, go the
// upstream gradient of the output row, wg the sample's G group weights.
//   dot_c   = sum over this lane's 8 channels of row * go   (per chunk)
//   part[ch] += wxy * dot_c                (-> d wg of the chunk's group)
//   dsum    += wg[group] * dot_c           (-> d x, d y through the hats)
//   drow    += wxy * wg[group] * go        when drow is given and that is not
//              zero: two 16-byte fp32 reductions per chunk (atomicAdd on
//              float4, compute capability 9.x), the lane's 8 channels being
//              contiguous and 32-byte aligned
template <int NCH>
__device__ __forceinline__ void tap_backward(const float (&v)[NCH][kVec],
                                             const float (&go)[NCH][kVec],
                                             const float* wg, float wxy,
                                             float (&part)[NCH], float& dsum,
                                             int C, int gd, int lane,
                                             float* drow = nullptr) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int c0 = (ch * 32 + lane) * kVec;
    if (c0 < C) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(v[ch][i], go[ch][i], dot);
      const float g = wg[c0 / gd];
      part[ch] = fmaf(wxy, dot, part[ch]);
      dsum = fmaf(g, dot, dsum);
      const float s = wxy * g;
      if (drow != nullptr && s != 0.f) {
        float4* d = reinterpret_cast<float4*>(drow + c0);
        atomicAdd(d, make_float4(s * go[ch][0], s * go[ch][1], s * go[ch][2], s * go[ch][3]));
        atomicAdd(d + 1, make_float4(s * go[ch][4], s * go[ch][5], s * go[ch][6], s * go[ch][7]));
      }
    }
  }
}

// Sum the per-chunk partials of one warp into the G group gradients:
// chunk j = ch*32 + lane covers channels [8j, 8j + 8), all in group 8j/gd.
// red is this warp's scratch of 32*kMaxChunks floats in shared memory.
template <int NCH>
__device__ __forceinline__ void store_group_sums(float* red, const float (&part)[NCH],
                                                 float* out, int C, int G, int lane) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) red[ch * 32 + lane] = part[ch];
  __syncwarp();
  const int per = C / G / kVec;  // chunks per group
  for (int g = lane; g < G; g += 32) {
    float s = 0.f;
    for (int j = g * per; j < (g + 1) * per; ++j) s += red[j];
    out[g] = s;
  }
  __syncwarp();
}

}  // namespace hipad
