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
// What bounds it on this card: bytes, and for a short gather the latency of
// its one wave. Each output row reads one table row and writes one row; the
// probes' 7.3 MB table stays in the 50 MB L2. P2 and P3 (8,192 rows, 33.5
// and 16.8 MB written) are many waves long and move bytes at the HBM rate.
// P4 writes only 1,024 rows (4.2 MB), one short wave: at one warp per row
// and eight rows a block that was 128 blocks, one per SM with 8 of its 64
// warp slots busy, each warp a dependent chain (index, row, store),
// governed by latency and a little slower than torch.index_select.
// Design: a row over two warps (each lane 4 of a 4096-byte row's 16-byte
// words, all loaded before any is stored), four rows a 256-thread block,
// so P4 spreads over 256 blocks and twice the warps; lane 0 of each warp
// reads the row's index and broadcasts it. Measured beside it (PERF.md):
// one warp a row (the earlier kernel), four and eight warps a row, and a
// cp.async.bulk copy of whole rows through shared memory on an mbarrier,
// one thread a row: none faster on P2-P4 by more than 0.0001 ms, the bulk
// copy the slowest on P3 and P4. Indices are not checked: they must lie in
// [0, N), as the Pallas kernels require too.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 64;  // two warps a row
constexpr int kRows = kThreads / kRowThreads;

// kPerLane > 0: rows of exactly kRowThreads * kPerLane words, unrolled; 0:
// any row length that is a multiple of 16 bytes, in a loop.
template <int kPerLane>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                  uint4* __restrict__ out, int n_out, int stride, int words_per_row) {
  const int row = blockIdx.x * kRows + threadIdx.x / kRowThreads;
  const int t = threadIdx.x % kRowThreads;
  if (row >= n_out) return;
  int src = 0;
  if ((threadIdx.x & 31) == 0) src = __ldg(idx + static_cast<long long>(row) * stride);
  src = __shfl_sync(0xffffffffu, src, 0);
  const uint4* from = table + static_cast<long long>(src) * words_per_row;
  uint4* to = out + static_cast<long long>(row) * words_per_row;
  if constexpr (kPerLane > 0) {
    uint4 v[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = __ldg(from + t + kRowThreads * j);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) to[t + kRowThreads * j] = v[j];
  } else {
    for (int w = t; w < words_per_row; w += kRowThreads) to[w] = __ldg(from + w);
  }
}

}  // namespace

// table [N, row_bytes] (any element type), idx [>= stride*(n_out-1)+1] int32,
// out [n_out, row_bytes]; row_bytes a multiple of 16, both pointers 16-byte
// aligned; blocks of four rows (kernels.row_gather_geometry). Returns
// cudaGetLastError() after the launch.
extern "C" int hipad_row_gather(const void* table, const void* idx, void* out, int n_out,
                                int stride, int row_bytes, int blocks, void* stream) {
  if (n_out <= 0) return 0;
  if (static_cast<long long>(blocks) * kRows < n_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(table);
  const int* i = static_cast<const int*>(idx);
  uint4* o = static_cast<uint4*>(out);
  const int words = row_bytes / 16;
  if (words == 256) {  // 1024 f32
    row_gather_kernel<4><<<blocks, kThreads, 0, st>>>(t, i, o, n_out, stride, words);
  } else if (words == 128) {  // 1024 bf16
    row_gather_kernel<2><<<blocks, kThreads, 0, st>>>(t, i, o, n_out, stride, words);
  } else {
    row_gather_kernel<0><<<blocks, kThreads, 0, st>>>(t, i, o, n_out, stride, words);
  }
  return static_cast<int>(cudaGetLastError());
}
