// Point sum: the sampler's last step, each anchor's points summed, in one
// launch.
//
// Replaces the keypoint sum of hipad_tpu/ops/sampling.py:990
// (deformable_aggregation_topk: flat.reshape(bs, anchors, P, C).sum(2)) with
// the rounding of the flat samples to the weights' dtype before it. Plain
// version: ops/sampling.py point_sum_plain (flat.to(dtype) ->
// .float().sum(dim=2) -> .to(dtype)):
//
//   out[b, a, c] = rnd(sum_p rnd(flat[b, a*P + p, c]))
//
// with rnd() the rounding to the output dtype and the sum in fp32, added in
// one fixed order of this kernel's own: input p joins chain p mod 16 (a
// strict sequence from 0), then the 16 chains' sums are added in chain
// order. The torch ops add in the order of torch's reduction, which depends
// on P, C and the pointer's alignment, so the two differ by the rounding of
// an fp32 sum (at most 2(P-1) 2^-24 sum_p |rnd(flat)|, then one unit in the
// last place of the output dtype); chip_smoke.py [kernels] reports the gap.
//
// What bounds it on this card: bytes. At the det task (11,700 samples, C =
// 256) it reads 12 MB and writes 0.5 MB (bf16), once, where the torch ops
// made four passes over the samples. Design: a block per (anchor, 128
// channels), lanes on channels (16-byte loads, 4 channels a lane), its 16
// rows on the chains, so the map task's 300 points a sum are read 16 at a
// time; the chains' sums meet in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kChains = 16;  // block rows: 32 x 16 = 512 threads

__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// flat [rows*P, C] fp32 -> out [rows, C] of T, 4 channels a lane; block
// (32, 16): row y sums chain y
template <typename T>
__global__ void __launch_bounds__(kLanes * kChains)
point_sum_kernel(const float* __restrict__ flat, T* __restrict__ out, long long rows, int P,
                 int C) {
  __shared__ float4 part[kChains][kLanes];
  const int ncb = (C + 4 * kLanes - 1) / (4 * kLanes);
  const int lane = threadIdx.x;
  const int y = threadIdx.y;
  for (long long blk = blockIdx.x; blk < rows * ncb; blk += gridDim.x) {
    const long long row = blk / ncb;
    const int c0 = (static_cast<int>(blk - row * ncb) * kLanes + lane) * 4;
    const bool live = c0 < C;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      const float* src = flat + row * P * C + c0;
#pragma unroll 4
      for (int p = y; p < P; p += kChains) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(src + static_cast<long long>(p) * C));
        acc.x = __fadd_rn(acc.x, rnd(v.x, out));
        acc.y = __fadd_rn(acc.y, rnd(v.y, out));
        acc.z = __fadd_rn(acc.z, rnd(v.z, out));
        acc.w = __fadd_rn(acc.w, rnd(v.w, out));
      }
    }
    part[y][lane] = acc;
    __syncthreads();
    if (y == 0 && live) {
      float4 s = part[0][lane];
#pragma unroll
      for (int r = 1; r < kChains; ++r) {
        const float4 v = part[r][lane];
        s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                        __fadd_rn(s.w, v.w));
      }
      store(out + row * C + c0, s);
    }
    __syncthreads();
  }
}

template <typename T>
void launch(const void* flat, void* out, long long rows, int P, int C, cudaStream_t st) {
  const long long blocks = rows * ((C + 4 * kLanes - 1) / (4 * kLanes));
  point_sum_kernel<T><<<static_cast<unsigned>(blocks < (1 << 30) ? blocks : (1 << 30)),
                        dim3(kLanes, kChains), 0, st>>>(static_cast<const float*>(flat),
                                                        static_cast<T*>(out), rows, P, C);
}

}  // namespace

// flat [rows*P, C] fp32 (rows = bs*anchors); out [rows, C] (fp32, or bf16
// when out_bf16 != 0); C % 4 == 0 and both pointers 16-byte aligned (the
// wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int hipad_point_sum(const void* flat, void* out, int out_bf16, long long rows, int P,
                               int C, void* stream) {
  if (P < 1 || C < 1 || C % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) launch<__nv_bfloat16>(flat, out, rows, P, C, st);
  else launch<float>(flat, out, rows, P, C, st);
  return static_cast<int>(cudaGetLastError());
}
