// P2-P4: row gather, out[i] = table[idx[stride * i]] over whole rows.
//
// Replaces the three Pallas gather probes of tools/probe_pallas_gather.py:
//   probe_a (P2): f32 table [N, 8, 128], one 1024-element row per (8,128)
//                 block, scalar-prefetched indices, stride 1;
//   probe_d (P3): bf16 table [N/2, 16, 128], two rows packed per (16,128)
//                 tile, then the odd/even select lo*(1-m) + hi*m. The packed
//                 layout is the same bytes as [N, 1024] rows and the select
//                 is exact for finite values, so it is a bf16 row gather,
//                 stride 1;
//   probe_c (P4): f32 block-index-map gather, grid step i copies the block
//                 idx[8i]: stride 8.
// The TPU kernels are shaped by Mosaic's tiling (dynamic indices only on an
// untiled leading dimension). None of that carries over: the function is a
// copy of whole rows, so the kernel moves 16-byte words and never looks at
// the element type.
//
// What bounds it on this card: bytes. Each output row reads one table row
// and writes one row; the P2 table (7.3 MB f32) stays in the 50 MB L2, so
// repeated rows are L2 hits and the floor is the HBM rate of the rows read
// once plus the output. Design: one warp per output row; lane 0 reads the
// index once and broadcasts it; each lane loads all its 16-byte words of
// the row into registers before it stores them (8 words of a 4096-byte f32
// row, 4 of a bf16 row: kPerLane), so a warp keeps the whole row in flight,
// and neighbouring lanes touch neighbouring addresses. Indices are not
// checked: they must lie in [0, N), as the Pallas kernels require too.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // output rows per block
constexpr int kThreads = 32 * kWarps;

// kPerLane > 0: rows of exactly 32 * kPerLane words, unrolled; 0: any row
// length that is a multiple of 16 bytes, in a loop.
template <int kPerLane>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                  uint4* __restrict__ out, int n_out, int stride,
                  int words_per_row) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_out) return;
  int src = 0;
  if (lane == 0) src = __ldg(idx + static_cast<long long>(row) * stride);
  src = __shfl_sync(0xffffffffu, src, 0);
  const uint4* from = table + static_cast<long long>(src) * words_per_row;
  uint4* to = out + static_cast<long long>(row) * words_per_row;
  if constexpr (kPerLane > 0) {
    uint4 v[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = __ldg(from + lane + 32 * j);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) to[lane + 32 * j] = v[j];
  } else {
    for (int w = lane; w < words_per_row; w += 32) to[w] = __ldg(from + w);
  }
}

}  // namespace

// table [N, row_bytes] (any element type), idx [>= stride*(n_out-1)+1] int32,
// out [n_out, row_bytes]; row_bytes a multiple of 16, both pointers 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int hipad_row_gather(const void* table, const void* idx, void* out,
                                int n_out, int stride, int row_bytes,
                                void* stream) {
  if (n_out <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_out + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(table);
  const int* i = static_cast<const int*>(idx);
  uint4* o = static_cast<uint4*>(out);
  const int words = row_bytes / 16;
  if (words == 256) {  // 1024 f32
    row_gather_kernel<8><<<blocks, kThreads, 0, st>>>(t, i, o, n_out, stride, words);
  } else if (words == 128) {  // 1024 bf16
    row_gather_kernel<4><<<blocks, kThreads, 0, st>>>(t, i, o, n_out, stride, words);
  } else {
    row_gather_kernel<0><<<blocks, kThreads, 0, st>>>(t, i, o, n_out, stride, words);
  }
  return static_cast<int>(cudaGetLastError());
}
