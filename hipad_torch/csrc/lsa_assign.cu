// K3: exact linear-sum assignment of every cost matrix of a training step,
// one block per matrix, all the step's problems (det and map) in one launch.
//
// Replaces hipad_tpu/targets/matching.py:36 (_lsa_single) and :116
// (assign): JAX solves every matching of the training step inside the
// jitted step with a lax.scan over rows around a lax.while_loop. In eager
// PyTorch that loop would read a device value at every iteration (a host
// sync each); the port's earlier host solver copied every cost matrix of
// the step to the host. This kernel keeps the matching on the card.
//
// What it computes, for each [R, C] matrix with its [R] row mask: entries
// that are NaN become +1e3, all are clipped to [-1e3, 1e3], rows that the
// mask marks invalid cost PAD = 3e4 everywhere, and R virtual columns of
// PAD are appended, so that every row finds a column. Then the
// shortest-augmenting-path Jonker-Volgenant algorithm with dual potentials
// (column 0 a sentinel, real columns at 1..C, virtual ones at C+1..C+R)
// adds the rows one by one. out[r] is the column of row r, or -1 for an
// invalid row and for a row that lands on a virtual column.
//
// Precision: the costs stay fp32, the duals u, v and the reduced costs minv
// are fp64, so 3e4-scale pads do not swallow real cost differences (JAX's
// fp32 duals can miss the optimum there). Each argmin takes the lowest
// column index on ties, as torch.argmin and jnp.argmin do, and every dual
// update is the same per-element operation as in the plain version
// (hipad_torch/targets/matching.py:assign_plain), so the two agree bit for
// bit.
//
// What bounds it on this card: neither bytes nor operations but the serial
// chain of inner iterations. A matrix of R rows takes R outer steps, each a
// few inner iterations; every inner iteration is a pass over the row's
// N = C + R + 1 columns, an argmin over them and a dual update, and the
// next iteration's row is the argmin's. A stage-2 step's det matrices take
// a few hundred iterations each, and the step waits for the slowest block.
// Design, to shorten each link of that chain:
//   (a) the sanitised costs are staged in shared memory once, by cp.async
//       (115,200 B for a det matrix), so no global read is left on an
//       iteration's path; the wrapper reads them from global memory as
//       before where R*C*4 and the state do not fit (kernels.lsa_plan);
//   (b) a column belongs to one thread for the whole solve (1 or 2 a
//       thread, a template argument), so v, minv and used live in
//       registers, and so do the row the column holds and that row's u
//       while the row stays there: a new row resets them in registers, and
//       the dual update makes no shared load. Only u and p, which every
//       thread reads, and way, which the augmenting walk reads, are in
//       shared memory;
//   (c) one barrier an inner iteration: each warp reduces its (value,
//       column) pairs, lane 0 writes them to a slot, and after the barrier
//       lane w of every warp reads slot w and reduces again, so every
//       thread holds the argmin without a second barrier. A warp's argmin
//       is three redux.sync minima over an order-preserving 64-bit key of
//       the value (its high word, its low word, then the column among the
//       lanes that hold the minimum): five butterfly rounds of shuffles
//       took half as long again (PERF.md). The slots are double-buffered:
//       iteration k+1 writes the other buffer while a late thread may
//       still read iteration k's. The dual update needs no
//       barrier: u[p[j]] is written by the owner of column j alone, and
//       the next iteration reads u of a row whose column is still unused.
//       Two barriers an outer row frame the augmenting walk;
//   (d) the problems of a step come in one launch (a Batch by value of up
//       to 8 problems, no copy to the card): blocks 0..n_det-1 take det,
//       the rest map, so the map blocks finish under the det ones. The
//       wrapper makes as many launches as more problems need, in order.
// What is left is instruction issue: every warp runs every iteration's pass
// and both argmin levels, at up to 32 warps a block. Half the warps with
// two columns a thread were slower on a stage-2 step (PERF.md), so a thread
// takes one column up to 1024 columns. Above 2048 padded columns the strip
// kernel takes the matrix: its column state lives in shared memory, or in
// global memory where that does not fit, so any matrix the card's memory
// holds is solved.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kClip = 1e3f;
constexpr float kPad = 3e4f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxProblems = 8;
// shared memory ahead of the state: 2 buffers x 32 warps of an 8-byte key
// and a 4-byte column
constexpr int kSlotBytes = 2 * 32 * 8 + 2 * 32 * 4;

struct Problem {
  const float* cost;     // [n, R, C]
  const uint8_t* mask;   // [n, R]
  int32_t* out;          // [n, R]
  int R, C;
  int staged;            // 1: the costs are staged in shared memory
  int first_block;       // the block of this problem's first matrix
  unsigned char* state;  // strips: each matrix's state in global memory, or null (shared)
};

struct Batch {
  Problem prob[kMaxProblems];
  int count;
};

// Bytes of shared memory before the staged costs (kernels.lsa_plan repeats
// this): the slots, u (fp64) and the row mask per row, p and way (int32)
// per padded column, rounded up to 16.
__host__ __device__ constexpr int state_bytes(int R, int C) {
  return (kSlotBytes + 8 * R + 8 * (C + R + 1) + R + 15) / 16 * 16;
}

// Bytes of one matrix's state in the strip kernel (kernels.lsa_plan repeats
// this): u (fp64) and the row mask per row; v, minv (fp64), p, way (int32)
// and used per padded column; rounded up to 16.
__host__ __device__ constexpr long long strip_state_bytes(long long R, long long C) {
  return (9 * R + 25 * (C + R + 1) + 15) / 16 * 16;
}

// The cost as the plain version reads it, but +0 for -0: the two compare
// equal, and with no -0 among the costs no -0 arises in the duals or the
// reduced costs either (x - y and x + y give -0 only from a -0), so the
// argmin's keys need no sign fix.
__device__ __forceinline__ float sanitised(float c) {
  if (isnan(c)) c = kClip;
  return fminf(fmaxf(c, -kClip), kClip) + 0.0f;
}

// A barrier of this block's first `threads` threads: the warps past a
// small matrix's columns have returned.
__device__ __forceinline__ void sync_active(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// (value, index) of the smaller, the lower index on equal values.
__device__ __forceinline__ void take_min(double& val, int& idx, double v2, int i2) {
  if (v2 < val || (v2 == val && i2 < idx)) {
    val = v2;
    idx = i2;
  }
}

// An unsigned key in the order of the doubles (no NaN and no -0 here, see
// sanitised), so equal values have equal keys and the column decides.
__device__ __forceinline__ unsigned long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b < 0 ? ~static_cast<unsigned long long>(b)
               : static_cast<unsigned long long>(b) | (1ull << 63);
}

__device__ __forceinline__ double key_value(unsigned long long k) {
  return __longlong_as_double(static_cast<long long>((k >> 63) ? k & ~(1ull << 63) : ~k));
}

__device__ __forceinline__ void warp_argmin_redux(unsigned long long& key, int& idx) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned mh = __reduce_min_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_min_sync(0xffffffffu, hi == mh ? lo : 0xffffffffu);
  const unsigned mi = __reduce_min_sync(0xffffffffu, hi == mh && lo == ml
                                                         ? static_cast<unsigned>(idx)
                                                         : 0xffffffffu);
  key = (static_cast<unsigned long long>(mh) << 32) | ml;
  idx = static_cast<int>(mi);
}

// The block's (delta, column): the argmin of every thread's (best, bj), in
// every thread, after one barrier.
__device__ __forceinline__ int block_argmin(double best, int bj, unsigned long long* key,
                                            int* col, int lane, int warp, int threads,
                                            double& delta) {
  unsigned long long k = order_key(best);
  warp_argmin_redux(k, bj);
  if (lane == 0) {
    key[warp] = k;
    col[warp] = bj;
  }
  sync_active(threads);
  k = key[lane];  // the slots of absent warps hold the largest key
  bj = col[lane];
  warp_argmin_redux(k, bj);
  delta = key_value(k);
  return bj;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Copy a matrix's R*C costs into shared memory, every copy in flight at
// once, then sanitise what this thread copied (invalid rows: PAD).
__device__ void stage_costs(float* cs, const float* cg, const uint8_t* mb, int R, int C,
                            int tid, int threads) {
  const int total = R * C;
  const int step = (reinterpret_cast<uintptr_t>(cg) % 16 == 0 && total % 4 == 0) ? 4 : 1;
  for (int e = step * tid; e < total; e += step * threads) {
    if (step == 4) {
      cp_async16(cs + e, cg + e);
    } else {
      cp_async4(cs + e, cg + e);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  for (int e0 = step * tid; e0 < total; e0 += step * threads) {
    for (int e = e0; e < e0 + step; ++e) cs[e] = mb[e / C] ? sanitised(cs[e]) : kPad;
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads, 1) lsa_assign_kernel(const Batch batch) {
  Problem P = batch.prob[0];
#pragma unroll
  for (int q = 1; q < kMaxProblems; ++q) {
    if (q < batch.count && static_cast<int>(blockIdx.x) >= batch.prob[q].first_block) {
      P = batch.prob[q];
    }
  }
  const int R = P.R, C = P.C, N = C + R + 1;
  const int threads = ((N + K - 1) / K + 31) / 32 * 32;  // this matrix's threads
  const int tid = threadIdx.x;
  if (tid >= threads) return;
  const int lane = tid & 31, warp = tid >> 5;
  const long long m = static_cast<long long>(blockIdx.x) - P.first_block;
  const float* cg = P.cost + m * R * C;
  const uint8_t* mb = P.mask + m * R;
  int32_t* ob = P.out + m * R;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* slot_key = reinterpret_cast<unsigned long long*>(smem);  // [2][32]
  int* slot_col = reinterpret_cast<int*>(smem + 2 * 32 * 8);                    // [2][32]
  double* u = reinterpret_cast<double*>(smem + kSlotBytes);
  int* p = reinterpret_cast<int*>(u + R);  // row held by column j, -1 free
  int* way = p + N;
  uint8_t* valid = reinterpret_cast<uint8_t*>(way + N);
  float* cs = reinterpret_cast<float*>(smem + state_bytes(R, C));

  for (int r = tid; r < R; r += threads) {
    u[r] = 0.0;
    valid[r] = mb[r] != 0;
  }
  for (int j = tid; j < N; j += threads) p[j] = j == 0 ? 0 : -1;  // row 0 enters at column 0
  for (int w = tid; w < 2 * 32; w += threads) {
    slot_key[w] = ~0ull;
    slot_col[w] = INT_MAX;
  }
  if (P.staged) stage_costs(cs, cg, mb, R, C, tid, threads);
  sync_active(threads);

  // registers of column tid + k*threads: v, minv, and the row it holds
  // with that row's u, which only this thread changes while the row's
  // column stays put (until the augmenting walk)
  double v[K], minv[K], urow[K];
  int prow[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0;
  for (int i = 0; i < R; ++i) {
    unsigned used = 0;  // bit k: column tid + k*threads
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * threads;
      minv[k] = CUDART_INF;
      prow[k] = j < N ? p[j] : -1;
      urow[k] = prow[k] >= 0 ? u[prow[k]] : 0.0;
    }
    int j0 = 0, i0 = i, buf = 0;
    while (true) {
      const double ui0 = u[i0];
      const float* srow = cs + i0 * C;
      const float* grow = cg + static_cast<long long>(i0) * C;
      const bool vi0 = P.staged || valid[i0];
      double best = CUDART_INF;
      int bj = INT_MAX;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + k * threads;
        if (j == j0) used |= 1u << k;
        if (j < N && !((used >> k) & 1u)) {
          double c = kPad;  // a virtual column, or an invalid row read from global memory
          if (j <= C) {
            if (P.staged) {
              c = srow[j - 1];
            } else if (vi0) {
              c = sanitised(__ldg(grow + j - 1));
            }
          }
          const double cur = c - ui0 - v[k];
          if (cur < minv[k]) {
            minv[k] = cur;
            way[j] = j0;
          }
          take_min(best, bj, minv[k], j);
        }
      }
      double delta;
      j0 = block_argmin(best, bj, slot_key + 32 * buf, slot_col + 32 * buf, lane, warp, threads,
                        delta);
      i0 = p[j0];
      // dual update: the used columns' rows gain delta, the used columns
      // lose it, the others' tentative distances shrink by it
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (tid + k * threads < N) {
          if ((used >> k) & 1u) {
            urow[k] += delta;
            u[prow[k]] = urow[k];
            v[k] -= delta;
          } else {
            minv[k] -= delta;
          }
        }
      }
      buf ^= 1;
      if (i0 == -1) break;
    }
    sync_active(threads);  // every thread is done reading p for row i
    if (tid == 0) {  // augment: walk the alternating path back to the sentinel
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
      p[0] = i + 1;  // the next row enters through the sentinel column
    }
    sync_active(threads);
  }

  // every row holds exactly one of the columns 1..N-1
  for (int j = 1 + tid; j < N; j += threads) {
    const int r = p[j];
    if (r >= 0) ob[r] = (valid[r] && j - 1 < C) ? j - 1 : -1;
  }
}

// The strip kernel: N > 1024 * kMaxCols padded columns, more than the
// registers of a block hold. Each thread takes the columns tid + k * 1024, a
// strip of them per inner iteration, and every column's v, minv, used, p and
// way live in memory beside u and the row mask: in shared memory where they
// fit (P.state null), else in this matrix's slice of P.state in global
// memory. The costs are read from global memory. The pass, the argmin, the
// dual update and the augmenting walk are the register kernel's, per column
// the same operations in the same order, so the result is again
// assign_plain's bit for bit.
__global__ void __launch_bounds__(kMaxThreads, 1) lsa_assign_strip_kernel(const Batch batch) {
  Problem P = batch.prob[0];
#pragma unroll
  for (int q = 1; q < kMaxProblems; ++q) {
    if (q < batch.count && static_cast<int>(blockIdx.x) >= batch.prob[q].first_block) {
      P = batch.prob[q];
    }
  }
  const int R = P.R, C = P.C, N = C + R + 1;
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long m = static_cast<long long>(blockIdx.x) - P.first_block;
  const float* cg = P.cost + m * R * C;
  const uint8_t* mb = P.mask + m * R;
  int32_t* ob = P.out + m * R;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* slot_key = reinterpret_cast<unsigned long long*>(smem);  // [2][32]
  int* slot_col = reinterpret_cast<int*>(smem + 2 * 32 * 8);                    // [2][32]
  unsigned char* base = P.state != nullptr ? P.state + m * strip_state_bytes(R, C)
                                           : smem + kSlotBytes;
  double* u = reinterpret_cast<double*>(base);
  double* v = u + R;
  double* minv = v + N;
  int* p = reinterpret_cast<int*>(minv + N);  // row held by column j, -1 free
  int* way = p + N;
  uint8_t* valid = reinterpret_cast<uint8_t*>(way + N);
  uint8_t* used = valid + R;

  for (int r = tid; r < R; r += threads) {
    u[r] = 0.0;
    valid[r] = mb[r] != 0;
  }
  for (int j = tid; j < N; j += threads) {
    p[j] = j == 0 ? 0 : -1;  // row 0 enters at column 0
    v[j] = 0.0;
  }
  for (int w = tid; w < 2 * 32; w += threads) {
    slot_key[w] = ~0ull;
    slot_col[w] = INT_MAX;
  }
  sync_active(threads);

  for (int i = 0; i < R; ++i) {
    for (int j = tid; j < N; j += threads) {
      minv[j] = CUDART_INF;
      used[j] = 0;
    }
    int j0 = 0, i0 = i, buf = 0;
    while (true) {
      const double ui0 = u[i0];
      const float* grow = cg + static_cast<long long>(i0) * C;
      const bool vi0 = valid[i0];
      double best = CUDART_INF;
      int bj = INT_MAX;
      for (int j = tid; j < N; j += threads) {
        if (j == j0) used[j] = 1;
        if (!used[j]) {
          double c = kPad;  // a virtual column, or an invalid row
          if (j <= C && vi0) c = sanitised(__ldg(grow + j - 1));
          const double cur = c - ui0 - v[j];
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j0;
          }
          take_min(best, bj, minv[j], j);
        }
      }
      double delta;
      j0 = block_argmin(best, bj, slot_key + 32 * buf, slot_col + 32 * buf, lane, warp, threads,
                        delta);
      i0 = p[j0];
      for (int j = tid; j < N; j += threads) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      buf ^= 1;
      if (i0 == -1) break;
    }
    sync_active(threads);  // every thread is done reading p for row i
    if (tid == 0) {  // augment: walk the alternating path back to the sentinel
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
      p[0] = i + 1;  // the next row enters through the sentinel column
    }
    sync_active(threads);
  }

  for (int j = 1 + tid; j < N; j += threads) {
    const int r = p[j];
    if (r >= 0) ob[r] = (valid[r] && j - 1 < C) ? j - 1 : -1;
  }
}

int launch_strips(const Batch& batch, int blocks, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsa_assign_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lsa_assign_strip_kernel<<<blocks, kMaxThreads, smem, stream>>>(batch);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const Batch& batch, int blocks, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsa_assign_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lsa_assign_kernel<K><<<blocks, threads, smem, stream>>>(batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `count` problems (1..8), each cost[q] [n[q], R[q], C[q]] fp32, mask[q]
// [n[q], R[q]] bool (one byte each), out[q] [n[q], R[q]] int32, all
// contiguous and on one device, n and R above 0; staged[q] 1 where the
// costs fit shared memory. One launch of cols columns a thread (1 or 2:
// the register kernel) or of column strips (cols 0: the strip kernel, 1024
// threads, each matrix's state in state[q] + m * its bytes where state[q]
// is not null, else in shared memory), `threads` threads and `smem` bytes
// of dynamic shared memory a block (kernels.lsa_plan). The arrays are host
// memory, read here. Returns cudaGetLastError() after the launch.
extern "C" int hipad_lsa_assign(int count, const void* const* cost, const void* const* mask,
                                void* const* out, void* const* state, const int* n,
                                const int* R, const int* C, const int* staged, int cols,
                                int threads, int smem, void* stream) {
  if (count < 1 || count > kMaxProblems) return static_cast<int>(cudaErrorInvalidValue);
  Batch batch{};
  batch.count = count;
  int blocks = 0;
  for (int q = 0; q < count; ++q) {
    batch.prob[q] = Problem{static_cast<const float*>(cost[q]),
                            static_cast<const uint8_t*>(mask[q]), static_cast<int32_t*>(out[q]),
                            R[q], C[q], staged[q], blocks,
                            static_cast<unsigned char*>(state[q])};
    blocks += n[q];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 0: return threads == kMaxThreads ? launch_strips(batch, blocks, smem, st)
                                          : static_cast<int>(cudaErrorInvalidValue);
    case 1: return launch<1>(batch, blocks, threads, smem, st);
    case 2: return launch<2>(batch, blocks, threads, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
