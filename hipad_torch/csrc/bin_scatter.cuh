// The deterministic scatter of K1-bwd (interp_sample_bwd.cu) and K2-bwd
// (patch_sample_bwd.cu): the map gradient of sampled bilinear taps, each
// element written once, its adds in an order fixed by the inputs alone.
//
// Items. The backward's first kernel (K1-bwd's sample blocks, K2-bwd's row
// kernel) writes one item per (sample, camera) or (slot, level) whose taps
// add into the map: its coordinates and an index (BinItem), and its bin, the
// key. A bin is (map, top tap row, x segment of the left tap column): the
// taps of an item lie in its top row and the row below, in its left column
// and the column to its right. The same kernel counts the items of each bin
// in each chunk of kBinChunk consecutive items with integer atomics, whose
// sums do not depend on their order.
//
// Order. bin_scan_kernel turns the counts of each bin into their prefix over
// the chunks (a warp per bin) and the bin's total; bin_base_kernel (one
// block) scans the totals once into each bin's first place; bin_place_kernel
// (a block per chunk, a thread per item) places each item after the bin's
// items of the chunks before its own and of the chunk's items before it (a
// match within its warp, a count over the earlier warps' keys): the items
// of a bin end up in item order, whatever the schedule (a stable counting
// sort by bin), and no thread waits on another's place.
//
// Cells. bin_cells_kernel: a warp per run of OW cells of one map row, lanes
// on channels (kVec a lane and chunk), its sums in fp32 registers. It reads
// the bins of top rows r-1 and r over the segments that hold the left tap
// columns of its cells (one contiguous run of items each), in order, lanes
// on items, keeps the taps that fall in its cells, then adds them in that
// order, batch_taps items' upstream rows and weights in flight at once. A
// cell of many taps (OW = 1) is split among `split` warps of one block,
// each taking a contiguous slice of its items; their partial sums are added
// in slice order in shared memory. Every cell's adds thus follow an order
// the items alone fix, and one warp writes each cell once, in the map's
// dtype: no zero fill, no atomics, the same bits on every run.
//
// What bounds it on this card: the latency of the dependent reads (an item,
// then its upstream row), and for K2-bwd's 88x160 maps the writes of the
// map gradient. A warp a cell (K1-bwd: ~50 taps a cell) or a run of 4
// (K2-bwd: ~1-4) keeps tens of warps an SM in flight, each with a few round
// trips: every read an item needs is issued together, a batch at a time.
#pragma once

#include "sample_common.cuh"

namespace hipad {
namespace {

struct __align__(16) BinItem {
  float x, y;  // the item's coordinates, as its sampler takes them
  int w_row;   // its row of G group weights
  int up_row;  // its row of the upstream gradient
};

constexpr int kBinChunk = 512;      // items a chunk of the counts: a place block's threads
constexpr int kBinMaxLevels = 4;    // map sizes in one cells launch
constexpr int kScanThreads = 256;   // a warp per bin

// The producer's part for item i: its key (-1: it adds nothing) and, for a
// live item, its payload and its count in hist [nbins][chunks].
__device__ __forceinline__ void bin_item(int* keys, BinItem* items, int* hist, int chunks,
                                         long long i, int key, float x, float y, int w_row,
                                         int up_row) {
  keys[i] = key;
  if (key >= 0) {
    items[i] = BinItem{x, y, w_row, up_row};
    atomicAdd(hist + static_cast<long long>(key) * chunks + i / kBinChunk, 1);
  }
}

// A warp per bin: hist[bin][c] -> the bin's items in the chunks before c;
// tot[bin] = its items in all. Lanes on consecutive chunks (coalesced),
// kScanBatch rounds of 32 chunks read at once, each round scanned across
// the warp and carried into the next.
constexpr int kScanBatch = 4;

__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(int* __restrict__ hist, int* __restrict__ tot, int nbins, int chunks) {
  const int bin = blockIdx.x * (kScanThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bin >= nbins) return;
  int* h = hist + static_cast<long long>(bin) * chunks;
  int carry = 0;
  for (int c0 = 0; c0 < chunks; c0 += 32 * kScanBatch) {
    int v[kScanBatch];
#pragma unroll
    for (int r = 0; r < kScanBatch; ++r) {
      const int c = c0 + r * 32 + lane;
      v[r] = c < chunks ? h[c] : 0;
    }
#pragma unroll
    for (int r = 0; r < kScanBatch; ++r) {
      int incl = v[r];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const int c = c0 + r * 32 + lane;
      if (c < chunks) h[c] = carry + incl - v[r];
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  if (lane == 0) tot[bin] = carry;
}

// One block: start [nbins + 1] <- the exclusive scan of the bins' totals,
// the last entry their sum. A tile of kBaseThreads * kBasePer totals at a
// time, read and written coalesced through shared memory; each thread scans
// kBasePer contiguous ones, the block its threads' sums; the tiles' sums
// carried.
constexpr int kBaseThreads = 1024;
constexpr int kBasePer = 8;

__global__ void __launch_bounds__(kBaseThreads)
bin_base_kernel(const int* __restrict__ tot, int* __restrict__ start, int nbins) {
  __shared__ int4 tile4[kBaseThreads * kBasePer / 4];
  __shared__ int warp_sum[kBaseThreads / 32];
  int* tile = reinterpret_cast<int*>(tile4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int t0 = 0; t0 < nbins; t0 += kBaseThreads * kBasePer) {
#pragma unroll
    for (int u = 0; u < kBasePer; ++u) {
      const int k = t0 + u * kBaseThreads + static_cast<int>(threadIdx.x);
      tile[u * kBaseThreads + threadIdx.x] = k < nbins ? tot[k] : 0;
    }
    __syncthreads();
    const int4 a = tile4[2 * threadIdx.x];
    const int4 b = tile4[2 * threadIdx.x + 1];
    int v[kBasePer] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int sum = 0;
#pragma unroll
    for (int u = 0; u < kBasePer; ++u) sum += v[u];
    int incl = sum;  // inclusive scan in the warp, then over the warps' sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    int run = carry + incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
#pragma unroll
    for (int u = 0; u < kBasePer; ++u) {
      const int x = v[u];
      v[u] = run;
      run += x;
    }
    tile4[2 * threadIdx.x] = make_int4(v[0], v[1], v[2], v[3]);
    tile4[2 * threadIdx.x + 1] = make_int4(v[4], v[5], v[6], v[7]);
    carry += warp_sum[kBaseThreads / 32 - 1];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kBasePer; ++u) {
      const int k = t0 + u * kBaseThreads + static_cast<int>(threadIdx.x);
      if (k < nbins) start[k] = tile[u * kBaseThreads + threadIdx.x];
    }
    __syncthreads();  // the tile and warp_sum are read before the next tile's writes
  }
  if (threadIdx.x == 0) start[nbins] = carry;
}

// A block per chunk of kBinChunk items, a thread each. pre: bin_scan_kernel's
// prefix of each bin over the chunks; start: bin_base_kernel's first place
// of each bin; out [items placed].
__global__ void __launch_bounds__(kBinChunk)
bin_place_kernel(const int* __restrict__ keys, const BinItem* __restrict__ items,
                 const int* __restrict__ pre, const int* __restrict__ start, long long n,
                 int chunks, BinItem* __restrict__ out) {
  __shared__ int4 ckeys4[kBinChunk / 4];
  int* ckeys = reinterpret_cast<int*>(ckeys4);
  const long long i = static_cast<long long>(blockIdx.x) * kBinChunk + threadIdx.x;
  const int key = i < n ? keys[i] : -1;
  BinItem it{};
  int base = 0;
  if (key >= 0) {  // issued before the count below, which hides their latency
    it = items[i];
    base = start[key] + pre[static_cast<long long>(key) * chunks + blockIdx.x];
  }
  ckeys[threadIdx.x] = key;
  __syncthreads();
  // the item's place: after the bin's items of the earlier chunks, of the
  // earlier warps of this chunk, and of the earlier lanes of its warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key < 0) return;
  int rank = __popc(peers & ((1u << lane) - 1u));
#pragma unroll 8
  for (int j = 0; j < warp * 8; ++j) {  // 4 keys a read, the same for every lane
    const int4 v = ckeys4[j];
    rank += (v.x == key) + (v.y == key) + (v.z == key) + (v.w == key);
  }
  out[base + rank] = it;
}

// The maps of one cells launch: up to kBinMaxLevels sizes, each with its
// segments and bins; the warps of level l are [warp0[l], warp0[l+1]),
// map-major, then row, then run of OW cells; its bins [bin0[l], ...): bin =
// bin0 + (map * rowbins + top row - tb0) * nseg + left tap column / sw.
template <typename T>
struct BinCells {
  T* dfm[kBinMaxLevels];  // [maps, H, W, C] each
  int H[kBinMaxLevels];
  int W[kBinMaxLevels];
  int sw[kBinMaxLevels];   // columns of a bin's segment
  int tb0[kBinMaxLevels];  // the top row of a map's first bin row
  int rowbins[kBinMaxLevels];
  int bin0[kBinMaxLevels];
  int warp0[kBinMaxLevels + 1];  // in runs of cells, each `split` warps
  int n;
  int split;  // warps a run of cells (1 where OW > 1)
};

// One map row r's taps of an item, restricted to the columns [xa, xb):
// columns ca, cb and their geometric weights sa, sb (-1 and 0 where the tap
// lies outside the columns or weighs nothing).
//
// K1-bwd: item (px, py) of map bc in pixels; the taps floor(px) + j of row
// r, weight hat(py - r) hat(px - col). A tap adds only where weight * wg is
// not zero.
struct K1Geo {
  static constexpr bool kSkipZeroScale = true;
  __device__ __forceinline__ void taps(const BinItem& it, int, int, int r, int xa, int xb,
                                       int& ca, float& sa, int& cb, float& sb) const {
    const float wy = hat(it.y - static_cast<float>(r));
    const int x0 = static_cast<int>(floorf(it.x));
    if (x0 >= xa && x0 < xb) sa = wy * hat(it.x - static_cast<float>(x0));
    if (x0 + 1 >= xa && x0 + 1 < xb) sb = wy * hat(it.x - static_cast<float>(x0 + 1));
    ca = sa != 0.f ? x0 : -1;
    cb = sb != 0.f ? x0 + 1 : -1;
  }
};

// K2-bwd: item (x, y) in normalised coordinates on a fine level of H x W;
// p = x W - 1/2 and q = y H - 1/2 rounded as the forward rounds them, the
// patch origin (sx, sy) clamped to [0, W-2] x [0, H-2], the taps (sy + i,
// sx + j), weight hat(q - sy - i) hat(p - sx - j). Every tap with a non-zero
// hat weight adds, whatever w.
struct K2Geo {
  static constexpr bool kSkipZeroScale = false;
  __device__ __forceinline__ void taps(const BinItem& it, int H, int W, int r, int xa, int xb,
                                       int& ca, float& sa, int& cb, float& sb) const {
    const float p = __fmul_rn(it.x, static_cast<float>(W)) - 0.5f;
    const float q = __fmul_rn(it.y, static_cast<float>(H)) - 0.5f;
    const float sxf = fminf(fmaxf(floorf(p), 0.f), static_cast<float>(W - 2));
    const float syf = fminf(fmaxf(floorf(q), 0.f), static_cast<float>(H - 2));
    const int sx = static_cast<int>(sxf);
    const float wy = hat(q - (syf + static_cast<float>(r - static_cast<int>(syf))));
    if (sx >= xa && sx < xb) sa = wy * hat(p - sxf);
    if (sx + 1 >= xa && sx + 1 < xb) sb = wy * hat(p - (sxf + 1.f));
    ca = sa != 0.f ? sx : -1;
    cb = sb != 0.f ? sx + 1 : -1;
  }
};

__device__ __forceinline__ void bin_store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void bin_store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// grid: the warps of every level (cl.warp0[cl.n] * cl.split), kThreads
// threads a block, with split > 1 (OW = 1 only) kWarps * NCH * kVec * 32
// floats of dynamic shared memory for the slices' partial sums. items and
// start: bin_place_kernel's out and start; gout [rows, C] and w [.., G]
// fp32. NCH chunks of kVec channels a lane (C <= 256 NCH), OW cells a run.
template <typename T, int NCH, int OW, class Geo>
__global__ void __launch_bounds__(kThreads)
bin_cells_kernel(BinCells<T> cl, Geo geo, const BinItem* __restrict__ items,
                 const int* __restrict__ start, const float* __restrict__ gout,
                 const float* __restrict__ w, int C, int G) {
  // items in flight: a warp of one cell (many taps) spends on upstream rows
  // the registers a warp of 4 (few taps) spends on its sums
  constexpr int B = batch_taps<NCH>() * (OW == 1 ? 2 : 1);
  extern __shared__ float bin_part[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gw0 = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const int slice = static_cast<int>(gw0 % cl.split);
  const long long gw = gw0 / cl.split;  // the run of cells
  // the warp's level, read with constant indices (an index computed at run
  // time would copy the parameters to local memory)
  int H = 0, W = 0, sw = 1, tb0 = 0, rowbins = 0, bin0 = 0, warp0 = 0;
  T* dfm = nullptr;
#pragma unroll
  for (int q = 0; q < kBinMaxLevels; ++q) {
    if (q < cl.n && gw >= cl.warp0[q]) {
      H = cl.H[q];
      W = cl.W[q];
      sw = cl.sw[q];
      tb0 = cl.tb0[q];
      rowbins = cl.rowbins[q];
      bin0 = cl.bin0[q];
      warp0 = cl.warp0[q];
      dfm = cl.dfm[q];
    }
  }
  // a warp past the last run still meets the block's barrier
  const bool active = gw < cl.warp0[cl.n];
  const int nrun = (W + OW - 1) / OW;
  int rel = static_cast<int>(gw - warp0);
  const int xa = (rel % nrun) * OW;
  const int xb = min(W, xa + OW);
  rel /= nrun;
  const int r = rel % H;
  const int map = rel / H;
  const int nseg = (W + sw - 1) / sw;
  const int gd = C / G;
  float acc[OW][NCH][kVec];
#pragma unroll
  for (int u = 0; u < OW; ++u) {
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[u][ch][e] = 0.f;
    }
  }
  // the items of top rows r-1 and r whose left tap column lies in [xa - 1,
  // xb - 1]: two runs of the bin order, [a0, a1) then [b0, b1), walked as one
  int a0 = 0, a1 = 0, b0 = 0, b1 = 0;
  if (active) {
    const int ta = r - 1 - tb0;
    const int tb = r - tb0;
    const int s0 = max(xa - 1, 0) / sw;
    const int s1 = (xb - 1) / sw + 1;
    if (ta >= 0 && ta < rowbins) {
      const int brow = bin0 + (map * rowbins + ta) * nseg;
      a0 = start[brow + s0];
      a1 = start[brow + s1];
    }
    if (tb >= 0 && tb < rowbins) {
      const int brow = bin0 + (map * rowbins + tb) * nseg;
      b0 = start[brow + s0];
      b1 = start[brow + s1];
    }
  }
  const int na = a1 - a0;
  const int total = na + b1 - b0;
  // this warp's slice of the run's items
  const int jb = static_cast<int>(static_cast<long long>(total) * slice / cl.split);
  const int je = static_cast<int>(static_cast<long long>(total) * (slice + 1) / cl.split);
  for (int j0 = jb; j0 < je; j0 += 32) {
    {
      const int j = j0 + lane;
      int ca = -1, cb = -1, wrow = 0, urow = 0;
      float sa = 0.f, sb = 0.f;
      if (j < je) {
        const BinItem it = items[j < na ? a0 + j : b0 + j - na];
        wrow = it.w_row;
        urow = it.up_row;
        geo.taps(it, H, W, r, xa, xb, ca, sa, cb, sb);
      }
      unsigned live = __ballot_sync(0xffffffffu, sa != 0.f || sb != 0.f);
      while (live != 0u) {
        int src[B];
        float g[B][NCH][kVec];
        float wv[B][NCH];
#pragma unroll
        for (int k = 0; k < B; ++k) {
          src[k] = live != 0u ? __ffs(live) - 1 : -1;
          live &= live - 1u;
          const int sl = src[k] < 0 ? 0 : src[k];
          const int wq = __shfl_sync(0xffffffffu, wrow, sl);
          const int uq = __shfl_sync(0xffffffffu, urow, sl);
          if (src[k] >= 0) {
            const float* row = gout + static_cast<long long>(uq) * C;
            const float* wr = w + static_cast<long long>(wq) * G;
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) {
              const int c0 = (ch * 32 + lane) * kVec;
              if (c0 < C) {
                load8(row + c0, g[k][ch]);
                wv[k][ch] = __ldg(wr + c0 / gd);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < B; ++k) {
          const int sl = src[k] < 0 ? 0 : src[k];
          const int qa = __shfl_sync(0xffffffffu, ca, sl);
          const int qb = __shfl_sync(0xffffffffu, cb, sl);
          const float ta = __shfl_sync(0xffffffffu, sa, sl);
          const float tb2 = __shfl_sync(0xffffffffu, sb, sl);
          if (src[k] < 0) continue;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            if ((ch * 32 + lane) * kVec >= C) continue;
            const float va = ta * wv[k][ch];
            const float vb = tb2 * wv[k][ch];
            // in the items' order, one cell after the other: this warp
            // alone sums its cells
#pragma unroll
            for (int u = 0; u < OW; ++u) {
              if (qa == xa + u && (!Geo::kSkipZeroScale || va != 0.f)) {
#pragma unroll
                for (int e = 0; e < kVec; ++e) acc[u][ch][e] = fmaf(va, g[k][ch][e], acc[u][ch][e]);
              }
              if (qb == xa + u && (!Geo::kSkipZeroScale || vb != 0.f)) {
#pragma unroll
                for (int e = 0; e < kVec; ++e) acc[u][ch][e] = fmaf(vb, g[k][ch][e], acc[u][ch][e]);
              }
            }
          }
        }
      }
    }
  }
  if (OW == 1 && cl.split > 1) {
    // the slices' partial sums, added in slice order by the first
    float* mine = bin_part + warp * NCH * kVec * 32;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) mine[(ch * kVec + e) * 32 + lane] = acc[0][ch][e];
    }
    __syncthreads();
    if (slice != 0) return;
    for (int q = 1; q < cl.split; ++q) {
      const float* theirs = mine + q * NCH * kVec * 32;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[0][ch][e] += theirs[(ch * kVec + e) * 32 + lane];
      }
    }
  }
  if (!active) return;
  T* out = dfm + ((static_cast<long long>(map) * H + r) * W + xa) * C;
#pragma unroll
  for (int u = 0; u < OW; ++u) {
    if (xa + u >= xb) break;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int c0 = (ch * 32 + lane) * kVec;
      if (c0 < C) bin_store8(out + static_cast<long long>(u) * C + c0, acc[u][ch]);
    }
  }
}

// The plan of one binned launch, as ops/kernels.py:BinPlan.host_ints lays
// it out in host memory: nbins, chunks, the cells launch's runs of cells,
// OW, the warps a run (split) and the levels' count, then per level sw,
// tb0, rowbins, bin0, warp0 (its first run).
struct BinPlan {
  int nbins, chunks, warps, ow, split, n;
  int sw[kBinMaxLevels], tb0[kBinMaxLevels], rowbins[kBinMaxLevels];
  int bin0[kBinMaxLevels], warp0[kBinMaxLevels];
};

constexpr int kPlanHead = 6;
constexpr int kPlanLevel = 5;

// The plan from its host ints -> false where it is out of range.
inline bool read_plan(const int* a, BinPlan& p) {
  p.nbins = a[0];
  p.chunks = a[1];
  p.warps = a[2];
  p.ow = a[3];
  p.split = a[4];
  p.n = a[5];
  if (p.n < 1 || p.n > kBinMaxLevels || p.nbins < 1 || p.chunks < 1 || p.warps < 1 ||
      (p.ow != 1 && p.ow != 4) || p.split < 1 || kWarps % p.split != 0 ||
      (p.ow != 1 && p.split != 1)) {
    return false;
  }
  for (int l = 0; l < p.n; ++l) {
    const int* q = a + kPlanHead + kPlanLevel * l;
    p.sw[l] = q[0];
    p.tb0[l] = q[1];
    p.rowbins[l] = q[2];
    p.bin0[l] = q[3];
    p.warp0[l] = q[4];
    if (p.sw[l] < 1 || p.rowbins[l] < 1) return false;
  }
  return true;
}

// Buffers of a binned launch (ops/kernels.py: one allocation, cut up).
struct BinScratch {
  int* keys;       // [items]
  BinItem* items;  // [items]
  int* hist;       // [nbins][chunks], zeroed here before the producer runs
  int* tot;        // [nbins]
  BinItem* out;    // [items]: the live items in bin order
  int* start;      // [nbins + 1]
};

// Before the producer: zero the counts.
inline cudaError_t bin_begin(const BinScratch& sc, const BinPlan& p, cudaStream_t st) {
  return cudaMemsetAsync(sc.hist, 0,
                         static_cast<size_t>(p.nbins) * p.chunks * sizeof(int), st);
}

template <typename T, int NCH, class Geo>
cudaError_t launch_cells(const BinCells<T>& cl, const BinPlan& p, Geo geo, const BinItem* items,
                         const int* start, const float* gout, const float* w, int C, int G,
                         cudaStream_t st) {
  const long long warps = static_cast<long long>(p.warps) * p.split;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  if (p.ow == 1) {
    const int smem = p.split > 1 ? kWarps * NCH * kVec * 32 * static_cast<int>(sizeof(float)) : 0;
    bin_cells_kernel<T, NCH, 1, Geo><<<blocks, kThreads, smem, st>>>(cl, geo, items, start, gout,
                                                                     w, C, G);
  } else {
    bin_cells_kernel<T, NCH, 4, Geo><<<blocks, kThreads, 0, st>>>(cl, geo, items, start, gout,
                                                                  w, C, G);
  }
  return cudaGetLastError();
}

// After the producer: the scans and the placement, then the cells of every
// level into dfm (one launch).
template <typename T, class Geo>
cudaError_t bin_finish(const BinScratch& sc, const BinPlan& p, long long n_items,
                       T* const* dfm, const int* H, const int* W, Geo geo,
                       const float* gout, const float* w, int C, int G, cudaStream_t st) {
  constexpr int per = kScanThreads / 32;
  bin_scan_kernel<<<(p.nbins + per - 1) / per, kScanThreads, 0, st>>>(sc.hist, sc.tot, p.nbins,
                                                                      p.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bin_base_kernel<<<1, kBaseThreads, 0, st>>>(sc.tot, sc.start, p.nbins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bin_place_kernel<<<p.chunks, kBinChunk, 0, st>>>(sc.keys, sc.items, sc.hist, sc.start, n_items,
                                                   p.chunks, sc.out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  BinCells<T> cl{};
  for (int l = 0; l < p.n; ++l) {
    cl.dfm[l] = dfm[l];
    cl.H[l] = H[l];
    cl.W[l] = W[l];
    cl.sw[l] = p.sw[l];
    cl.tb0[l] = p.tb0[l];
    cl.rowbins[l] = p.rowbins[l];
    cl.bin0[l] = p.bin0[l];
    cl.warp0[l] = p.warp0[l];
  }
  cl.warp0[p.n] = p.warps;
  cl.n = p.n;
  cl.split = p.split;
  switch ((C + 32 * kVec - 1) / (32 * kVec)) {
    case 1: return launch_cells<T, 1>(cl, p, geo, sc.out, sc.start, gout, w, C, G, st);
    case 2: return launch_cells<T, 2>(cl, p, geo, sc.out, sc.start, gout, w, C, G, st);
    case 3: return launch_cells<T, 3>(cl, p, geo, sc.out, sc.start, gout, w, C, G, st);
    default: return launch_cells<T, kMaxChunks>(cl, p, geo, sc.out, sc.start, gout, w, C, G, st);
  }
}

}  // namespace
}  // namespace hipad
