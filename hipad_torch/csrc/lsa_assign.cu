// K3: exact linear-sum assignment of a batch of cost matrices, one block per
// matrix.
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
// chain of augmenting iterations. A matrix of R rows takes R outer steps,
// each a few inner iterations, and every inner iteration is a pass over the
// row's N = C + R + 1 columns, a min-reduction over them and a dual update,
// with a barrier between each. PERF.md's bound (the cost bytes read once
// over 3.35 TB/s) is far below what that chain allows. Design: the column
// state (v, minv fp64; p, way int32; used) and u live in shared memory (at
// most about 23 KB at stage 2: N = 933), cost rows are read from global
// memory, where the step's matrices stay in L2. A column belongs to thread
// j % kThreads throughout, so marking a column used and updating its
// state needs no barrier; the (value, index) argmin is a warp shuffle
// reduction, then one across the block's eight warps. One warp a matrix
// (__syncwarp in place of __syncthreads) was measured and not taken: it
// was about four times slower on a stage-2 step's det matrices (PERF.md).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr float kClip = 1e3f;
constexpr float kPad = 3e4f;

// Column j (0 the sentinel, 1..C real, C+1..C+R virtual) of a row of the
// padded, sanitised matrix, as the plain version builds it.
__device__ __forceinline__ double padded_cost(const float* __restrict__ row, bool valid,
                                              int j, int C) {
  if (j == 0) return 0.0;
  if (!valid || j > C) return static_cast<double>(kPad);
  float c = __ldg(row + j - 1);
  if (isnan(c)) c = kClip;
  c = fminf(fmaxf(c, -kClip), kClip);
  return static_cast<double>(c);
}

// (value, index) of the smaller, the lower index on equal values.
__device__ __forceinline__ void take_min(double& val, int& idx, double v2, int i2) {
  if (v2 < val || (v2 == val && i2 < idx)) {
    val = v2;
    idx = i2;
  }
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
lsa_assign_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ mask,
                  int32_t* __restrict__ out, int R, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = C + R + 1;
  double* v = reinterpret_cast<double*>(smem);
  double* minv = v + N;
  double* u = minv + N;
  int* p = reinterpret_cast<int*>(u + R);  // row held by column j, -1 free
  int* way = p + N;
  unsigned char* used = reinterpret_cast<unsigned char*>(way + N);
  __shared__ double red_val[kWarps];
  __shared__ int red_idx[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* cb = cost + static_cast<long long>(blockIdx.x) * R * C;
  const uint8_t* mb = mask + static_cast<long long>(blockIdx.x) * R;
  int32_t* ob = out + static_cast<long long>(blockIdx.x) * R;

  for (int j = tid; j < N; j += kThreads) {
    v[j] = 0.0;
    p[j] = -1;
  }
  for (int r = tid; r < R; r += kThreads) u[r] = 0.0;
  __syncthreads();

  for (int i = 0; i < R; ++i) {
    for (int j = tid; j < N; j += kThreads) {
      minv[j] = CUDART_INF;
      used[j] = 0;
      way[j] = 0;
    }
    if (tid == 0) p[0] = i;  // row i enters through the sentinel column
    __syncthreads();
    int j0 = 0;
    while (true) {
      const int i0 = p[j0];
      const bool valid = mb[i0] != 0;
      const float* row = cb + static_cast<long long>(i0) * C;
      const double ui0 = u[i0];
      double best = CUDART_INF;
      int bj = N;
      for (int j = tid; j < N; j += kThreads) {
        if (j == j0) used[j] = 1;
        if (!used[j]) {
          const double cur = padded_cost(row, valid, j, C) - ui0 - v[j];
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j0;
          }
          take_min(best, bj, minv[j], j);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        take_min(best, bj, __shfl_xor_sync(0xffffffffu, best, o),
                 __shfl_xor_sync(0xffffffffu, bj, o));
      }
      if (lane == 0) {
        red_val[tid >> 5] = best;
        red_idx[tid >> 5] = bj;
      }
      __syncthreads();
      best = red_val[0];
      bj = red_idx[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) take_min(best, bj, red_val[w], red_idx[w]);
      const double delta = best;
      // dual update: the used columns' rows gain delta, the used columns
      // lose it, the others' tentative distances shrink by it
      for (int j = tid; j < N; j += kThreads) {
        if (used[j]) {
          const int r = p[j];
          if (r >= 0) u[r] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      __syncthreads();
      j0 = bj;
      if (p[j0] == -1) break;
    }
    if (tid == 0) {  // augment: walk the alternating path back to the sentinel
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
      p[0] = -1;
    }
    __syncthreads();
  }

  for (int r = tid; r < R; r += kThreads) ob[r] = -1;
  __syncthreads();
  for (int j = 1 + tid; j < N; j += kThreads) {
    const int r = p[j];
    if (r >= 0) ob[r] = (mb[r] != 0 && j - 1 < C) ? j - 1 : -1;
  }
}

}  // namespace

// cost [n, R, C] fp32, mask [n, R] bool (one byte each), out [n, R] int32,
// all contiguous. Returns cudaGetLastError() after the launch.
extern "C" int hipad_lsa_assign(const void* cost, const void* mask, void* out, int n, int R,
                                int C, void* stream) {
  if (n <= 0 || R <= 0) return 0;
  const int N = C + R + 1;
  const size_t smem = static_cast<size_t>(N) * (2 * sizeof(double) + 2 * sizeof(int) + 1) +
                      static_cast<size_t>(R) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsa_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lsa_assign_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(out), R, C);
  return static_cast<int>(cudaGetLastError());
}
