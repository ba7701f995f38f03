// Camera selection: the glue between the sampler's inputs and K2, in one
// launch.
//
// Replaces the camera top-k of hipad_tpu/ops/sampling.py:745-780 as
// deformable_samples_topk_flat runs it (the inside mask, topk_by_argmax over
// the cameras, the one-hot gathers of the points, the mask and the weights,
// the camera renormalisation) and the fine-level list index that follows it.
// Plain version: ops/sampling.py select_cameras_plain.
//
// For each flat sample m of bs*M0, with points [cams, 2] and weights
// [cams, L, G]:
//   in_c   = 0 < x_c < 1 and 0 < y_c < 1
//   cam_j  = the j-th camera of (in-bounds cameras by index, then the others
//            by index), j < cam_k: torch.topk of the distinct keys
//            in_c * cams - c
//   w_j    = rnd(w[cam_j, l, g] * in_{cam_j})
//   with renorm and cam_k < cams:
//   full   = sum_c rnd(w[c, l, g] * in_c), kept = sum_j w_j (fp32)
//   w_j    = rnd(w_j * rnd(full / max(kept, 1e-9)))
// where rnd() rounds to the weights' dtype. Both sums add in camera (slot)
// order; torch's reduction adds in another, so with the renormalisation the
// weights may differ from the torch ops' by the rounding of those sums (a
// few units in the last place: chip_smoke.py [kernels]); cam, x, y and the
// weights without it are equal.
//
// Outputs, what patch_sample takes: cam [bs*M0*cam_k] int32, x, y the same
// fp32, w_fine [bs*M0*cam_k, n_fine, G] fp32 for the fine levels `fine`.
//
// What bounds it on this card: launch latency. At the det task (M0 =
// 11,700, 6 cameras, 2 fine levels of 8 groups, bf16) it reads 0.56 MB of
// points and 1.1 MB of the fine levels' weights and writes 1.7 MB. Design: a
// thread per (sample, fine level, group), 16 a sample at stage 2: each reads
// the sample's 6 points (in the layout the model hands over, cameras
// furthest apart: no copy to make them contiguous), ranks the cameras
// in registers (4 bits a slot) and reads its weights on the kept cameras
// (on every camera for the renormalisation); the threads of a sample write
// its w_fine rows together, and the first cam_k of them its cam, x and y.
// A first draft that ranked every slot by loops over the cameras took 15.5
// us a det call on an H100, its arithmetic repeated by a sample's 16 threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCams = 8;
constexpr int kMaxFine = 4;

struct Fine {
  int l[kMaxFine];
  int n;
};

// the points' strides in floats: batch, sample, camera, coordinate (the
// model hands the sampler a view whose cameras lie furthest apart)
struct Strides {
  long long b, m, c, d;
};

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// round to the weights' dtype, as torch stores each op's result
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the n first of v summed in order, in fp32
__device__ __forceinline__ float sum_in_order(const float (&v)[kMaxCams], int n) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxCams; ++i) {
    if (i < n) s = __fadd_rn(s, v[i]);
  }
  return s;
}

// The cameras in rank order, 4 bits a slot: the in-bounds cameras `in` by
// index, then the others by index.
__device__ __forceinline__ unsigned rank_order(unsigned in, int cams) {
  const int n_in = __popc(in);
  unsigned order = 0;
  int pin = 0, pout = n_in;
#pragma unroll
  for (int c = 0; c < kMaxCams; ++c) {
    if (c < cams) {
      const int slot = (in >> c & 1u) ? pin++ : pout++;
      order |= static_cast<unsigned>(c) << (4 * slot);
    }
  }
  return order;
}

// 32-bit indices (the wrapper keeps the thread count below 2^31): a 64-bit
// division costs as much as the rest of a thread's arithmetic
template <typename T>
__global__ void __launch_bounds__(kThreads)
cam_select_kernel(const float* __restrict__ pts, Strides ps, const T* __restrict__ w,
                  int* __restrict__ cam, float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ wf, unsigned samples, unsigned M0, int cams, int L, int G,
                  Fine fine, int cam_k, int renorm) {
  const unsigned per = fine.n * G;  // threads a sample
  const unsigned total = samples * per;
  for (unsigned t = blockIdx.x * kThreads + threadIdx.x; t < total; t += gridDim.x * kThreads) {
    const unsigned m = t / per;
    const int r = static_cast<int>(t - m * per);
    const int f = r / G;
    const int g = r - f * G;
    // the level by constant indices: a dynamic index into the kernel's
    // parameters would copy them to local memory
    int l = fine.l[0];
#pragma unroll
    for (int i = 1; i < kMaxFine; ++i) {
      if (i == f) l = fine.l[i];
    }

    const unsigned b = m / M0;
    const float* p =
        pts + static_cast<long long>(b) * ps.b + static_cast<long long>(m - b * M0) * ps.m;
    unsigned in = 0;
#pragma unroll
    for (int c = 0; c < kMaxCams; ++c) {
      if (c < cams) {
        const float qx = __ldg(p + c * ps.c);
        const float qy = __ldg(p + c * ps.c + ps.d);
        if (qx > 0.f && qx < 1.f && qy > 0.f && qy < 1.f) in |= 1u << c;
      }
    }
    const unsigned order = rank_order(in, cams);

    // this (level, group)'s weight on each kept camera, times its mask
    const T* wp = w + (static_cast<long long>(m) * cams * L + l) * G + g;
    const int lg = L * G;
    float kept[kMaxCams];
#pragma unroll
    for (int i = 0; i < kMaxCams; ++i) {
      kept[i] = 0.f;
      if (i < cam_k) {
        const int c = order >> (4 * i) & 15u;
        kept[i] = rnd(__fmul_rn(load_w(wp + c * lg), (in >> c & 1u) ? 1.f : 0.f), w);
      }
    }
    if (renorm) {
      float wm[kMaxCams];
#pragma unroll
      for (int c = 0; c < kMaxCams; ++c) {
        wm[c] = c < cams ? rnd(__fmul_rn(load_w(wp + c * lg), (in >> c & 1u) ? 1.f : 0.f), w)
                         : 0.f;
      }
      const float full = sum_in_order(wm, cams);
      const float k = sum_in_order(kept, cam_k);
      const float den = isnan(k) ? k : fmaxf(k, 1e-9f);  // torch.clamp keeps a NaN
      const float ratio = rnd(__fdiv_rn(full, den), w);
#pragma unroll
      for (int i = 0; i < kMaxCams; ++i) kept[i] = rnd(__fmul_rn(kept[i], ratio), w);
    }

    const long long s0 = static_cast<long long>(m) * cam_k;  // the sample's first slot
#pragma unroll
    for (int i = 0; i < kMaxCams; ++i) {
      if (i < cam_k) wf[((s0 + i) * fine.n + f) * G + g] = kept[i];
    }
    for (int i = r; i < cam_k; i += static_cast<int>(per)) {
      const int c = order >> (4 * i) & 15u;
      cam[s0 + i] = c;
      x[s0 + i] = __ldg(p + c * ps.c);
      y[s0 + i] = __ldg(p + c * ps.c + ps.d);
    }
  }
}

template <typename T>
void launch(const void* points, const Strides& ps, const void* weights, void* cam, void* x,
            void* y, void* w_fine, long long samples, long long M0, int cams, int L, int G,
            const Fine& fine, int cam_k, int renorm, cudaStream_t st) {
  const long long total = samples * fine.n * G;
  const long long blocks = (total + kThreads - 1) / kThreads < (1 << 20)
                               ? (total + kThreads - 1) / kThreads
                               : (1 << 20);
  cam_select_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(points), ps, static_cast<const T*>(weights),
      static_cast<int*>(cam), static_cast<float*>(x), static_cast<float*>(y),
      static_cast<float*>(w_fine), static_cast<unsigned>(samples), static_cast<unsigned>(M0),
      cams, L, G, fine, cam_k, renorm);
}

}  // namespace

// points [bs, M0, cams, 2] fp32 with strides sb, sm, sc, sd (in floats);
// weights [bs*M0, cams, L, G] contiguous (fp32, or bf16 when w_bf16 != 0);
// fine levels f0..f3, the first nfine used, each in [0, L); cam [bs*M0*cam_k]
// int32, x, y [bs*M0*cam_k] fp32, w_fine [bs*M0*cam_k, nfine, G] fp32.
// Needs 1 <= cams <= 8, 1 <= cam_k <= cams, 1 <= nfine <= 4 and
// bs*M0*nfine*G < 2^31 (the wrapper checks); renorm applies only where
// cam_k < cams. Returns cudaGetLastError() after the launch.
extern "C" int hipad_cam_select(const void* points, long long sb, long long sm, long long sc,
                                long long sd, const void* weights, int w_bf16, void* cam,
                                void* x, void* y, void* w_fine, long long bs, long long M0,
                                int cams, int L, int G, int f0, int f1, int f2, int f3, int nfine,
                                int cam_k, int renorm, void* stream) {
  const long long samples = bs * M0;
  if (cams < 1 || cams > kMaxCams || cam_k < 1 || cam_k > cams || nfine < 1 ||
      nfine > kMaxFine || G < 1 || samples * nfine * G >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (samples * nfine * G <= 0) return 0;
  const Fine fine{{f0, f1, f2, f3}, nfine};
  const Strides ps{sb, sm, sc, sd};
  const int go = renorm && cam_k < cams;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    launch<__nv_bfloat16>(points, ps, weights, cam, x, y, w_fine, samples, M0, cams, L, G, fine,
                          cam_k, go, st);
  } else {
    launch<float>(points, ps, weights, cam, x, y, w_fine, samples, M0, cams, L, G, fine, cam_k,
                  go, st);
  }
  return static_cast<int>(cudaGetLastError());
}
