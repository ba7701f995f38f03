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

// ---- pieces of the two forward kernels ---------------------------------
//
// A warp first lists the taps of its row (each feature row it will read,
// with its bilinear weight) in shared memory, lanes computing them in
// parallel, then reads the list in batches: every 16-byte load of a batch
// is issued before the batch's first FMA, so a warp keeps a batch of rows in
// flight where one row at a time left it waiting on each load's latency.
//
// Blocks hold 4 warps (kFwdWarps), one row each: a block's registers and
// shared memory return to the SM only when its slowest row is done, and
// rows differ in their number of taps (0 to 48 in K1). Measured on an H100,
// 4-warp blocks and batches of 4 taps beat 8-warp blocks and batches of 8
// (the registers of a batch of 8 cost warps); a ring of rows fetched into
// shared memory by cp.async, which holds no registers, lost to them.

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;

// One lane's kVec channels of one feature row as loaded: two 16-byte words
// (fp32) or one (bf16, widened to fp32 where it is used).
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 a, b;
};
template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ void load_raw(const float* p, Raw<float>& r) {
  r.a = __ldg(reinterpret_cast<const float4*>(p));
  r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, Raw<__nv_bfloat16>& r) {
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
}

// acc += s * row over the lane's kVec channels
__device__ __forceinline__ void fma_raw(float (&acc)[kVec], float s, const Raw<float>& r) {
  acc[0] = fmaf(s, r.a.x, acc[0]);
  acc[1] = fmaf(s, r.a.y, acc[1]);
  acc[2] = fmaf(s, r.a.z, acc[2]);
  acc[3] = fmaf(s, r.a.w, acc[3]);
  acc[4] = fmaf(s, r.b.x, acc[4]);
  acc[5] = fmaf(s, r.b.y, acc[5]);
  acc[6] = fmaf(s, r.b.z, acc[6]);
  acc[7] = fmaf(s, r.b.w, acc[7]);
}

__device__ __forceinline__ void fma_raw(float (&acc)[kVec], float s,
                                        const Raw<__nv_bfloat16>& r) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] = fmaf(s, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(s, f.y, acc[2 * i + 1]);
  }
}

// One tap of a warp's list: a feature row and its bilinear weight; pair
// indexes the warp's [pairs, G] group weights in shared memory.
template <typename T>
struct Tap {
  const T* row;
  float w;
  int pair;
};

// Append each lane's taps (tap[k] for the set bits k of mask, in order) to
// the warp's list, lane after lane -> the list's length. Every lane of the
// warp calls it.
template <typename T>
__device__ __forceinline__ int list_taps(Tap<T>* list, const Tap<T> (&tap)[4], unsigned mask,
                                         int lane) {
  const int n = __popc(mask);
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  int j = incl - n;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (mask >> k & 1u) list[j++] = tap[k];
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, incl, 31);
}

// tot += the warp's taps list[0, n), summed as runs: the consecutive taps
// whose pair / per_run is equal form one run, summed in list order into
// s = sum w * wg[pair, group(c)] * row[c] from zero, then tot += s. K1 makes
// one run per coarse level (tot = (acc + s_2) + s_3, as adding each level's
// camera sum in turn does), K2 one run of all its taps. The loads of B taps
// are issued before the first FMA of the B. NCH chunks of kVec channels per
// lane, C <= 256 * NCH.
template <typename T, int NCH, int B>
__device__ __forceinline__ void sum_taps(const Tap<T>* list, int n, const float* wg, int per_run,
                                         int C, int G, int lane, float (&tot)[NCH][kVec]) {
  const int gd = C / G;
  float s[NCH][kVec];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[ch][i] = 0.f;
  }
  int run = n > 0 ? list[0].pair / per_run : 0;
  for (int t0 = 0; t0 < n; t0 += B) {
    Raw<T> v[B][NCH];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (t0 + j < n) {
        const T* row = list[t0 + j].row;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int c0 = (ch * 32 + lane) * kVec;
          if (c0 < C) load_raw(row + c0, v[j][ch]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (t0 + j < n) {
        const float w = list[t0 + j].w;
        const int pair = list[t0 + j].pair;
        if (pair / per_run != run) {
          run = pair / per_run;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
              tot[ch][i] += s[ch][i];
              s[ch][i] = 0.f;
            }
          }
        }
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int c0 = (ch * 32 + lane) * kVec;
          if (c0 < C) fma_raw(s[ch], w * wg[pair * G + c0 / gd], v[j][ch]);
        }
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) tot[ch][i] += s[ch][i];
  }
}

// Taps a lane of a forward kernel reads at once: 4 rows at C <= 256 (32
// registers of fp32 values), fewer for wider rows.
template <int NCH>
__host__ __device__ constexpr int batch_taps() {
  return NCH == 1 ? 4 : (NCH == 2 ? 2 : 1);
}

// Bytes of one warp's shared memory in a forward kernel: its tap list (at
// most 4 taps a pair) and its [pairs, G] group weights, rounded to 16.
__host__ __device__ __forceinline__ int warp_smem_bytes(int pairs, int G) {
  return (pairs * 4 * 16 + pairs * G * 4 + 15) / 16 * 16;
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
template <int NCH>
__device__ __forceinline__ void tap_backward(const float (&v)[NCH][kVec],
                                             const float (&go)[NCH][kVec],
                                             const float* wg, float wxy,
                                             float (&part)[NCH], float& dsum,
                                             int C, int gd, int lane) {
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
