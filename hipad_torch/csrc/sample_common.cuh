// Shared pieces of the two sampler kernels (interp_sample.cu, patch_sample.cu).
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

}  // namespace hipad
