// GroupNorm statistics and the GroupNorm / FiLM fold on Hopper (sm_90a),
// in one launch:
//     mean, var of x over each (batch, group) slab of T x C / G values,
//     a = rstd * gamma,  b = beta - mean * a,  rstd = 1 / sqrt(var + eps),
//     with FiLM  a <- a * (1 + scale),  b <- b * (1 + scale) + shift,
// the per-(batch, channel) f32 affine that the resnet epilogue kernels
// (gn_silu_conv1d_tc.cu, gn_silu_conv1d.cu) apply before the SiLU.
// x (B, T, C) bf16 or f32, contiguous; gamma, beta (C,) and scale, shift
// (B, C) rows `film_stride` apart, f32 or bf16 (one dtype for the four);
// a, b (B, C) f32. Under autograd the wrapper also passes (B, G) f32
// buffers for each slab's mean and rstd, which the backward
// (group_norm_affine_bwd.cu) reads instead of x's statistics; without
// grad (serving, sampling, capture) they are null and nothing more is
// written.
//
// Replaces: the XLA reductions of ns2vc_tpu/ops/pallas_resnet.py::
// gn_silu_conv1d (:121-132: an f32 copy of x, mean and centred var over
// axes (1, 3), rsqrt, the two repeats and the fold), which the port ran as
// about a dozen torch launches per resnet epilogue.
//
// What bounds it on the H100: bytes. It reads x once and writes two f32
// values per (batch, channel); a handful of f32 operations per element is
// far below the card's compute rate. At the serving shapes x is 0.4-3.7 MB
// per call, so one call is a few microseconds at 3.35 TB/s and its launch
// and the latency of its loads weigh as much as the bytes.
// What the design does about it: a grid of (S, G, B) blocks of 512 threads,
// S blocks per (batch, group) slab forming one thread block cluster; block
// s of the cluster reduces frames [s T / S, (s + 1) T / S) of the slab.
// Each thread keeps 8 loads in flight before it folds them in, 16-byte
// vectors (8 bf16 or 4 f32 of one row of the slab) when the group's
// channels come in whole vectors and x is 16-byte aligned, else single
// elements; the wrapper's `gn_splits` takes the fewest blocks per slab
// that read it in one such round each (one at the serving widths, where
// B * G = 128 blocks then cover the card at B = 16, more for long slabs:
// the CLI's B = 1 buckets), so a call costs about one memory round trip
// plus the merge. The variance is centred, as the
// JAX wrapper's: each vector gives its own exact mean and sum of squared
// deviations, and (count, mean, M2) partials merge by Chan's pairwise rule,
// in f32, per thread, then across the warp by shuffles, the block's warps
// in order, and the cluster's blocks in order of rank through distributed
// shared memory. The merge order is fixed by the indices alone: two
// launches on the same input give bitwise-equal a, b, with no atomics.
// Block 0 of the cluster then folds gamma, beta and FiLM per channel in the
// plain version's order of operations (no contraction into FMAs).
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kLoads = 8;   // vectors in flight per thread

struct Moments {
  float n, mean, m2;   // count, mean, sum of squared deviations
};

// Chan et al.'s pairwise merge of two partial moments
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// the exact moments of one vector of V values
template <int V>
__device__ __forceinline__ Moments vector_moments(const float (&v)[V]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += v[i];
  const float mean = s * (1.f / V);
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) m2 = fmaf(v[i] - mean, v[i] - mean, m2);
  return {float(V), mean, m2};
}

// V values of x at p: one 16-byte load (V * sizeof(X) == 16) or V = 1
template <typename X, int V>
__device__ __forceinline__ void load_vec(const X* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f(__ldg(p));
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const X* e = reinterpret_cast<const X*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
  }
}

template <typename X, typename P, int V>
__global__ void __launch_bounds__(kThreads)
group_norm_affine_kernel(const X* __restrict__ x, const P* __restrict__ gamma,
                         const P* __restrict__ beta,
                         const P* __restrict__ scale,
                         const P* __restrict__ shift, int film_stride,
                         float* __restrict__ a_out, float* __restrict__ b_out,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int Tlen, int C,
                         float eps) {
  __shared__ Moments warp_part[kThreads / 32];
  __shared__ Moments block_part;
  __shared__ float stats[2];   // mean, rstd of the slab

  const int S = gridDim.x, s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.y, cg = C / G, nv = cg / V;
  const int t_lo = int(int64_t(s) * Tlen / S);
  const int t_hi = int(int64_t(s + 1) * Tlen / S);
  const int items = (t_hi - t_lo) * nv;
  const X* xs = x + (int64_t(b) * Tlen + t_lo) * C + g * cg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  Moments m = {0.f, 0.f, 0.f};
  for (int base = tid; base < items; base += kThreads * kLoads) {
    float v[kLoads][V];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int it = base + u * kThreads;
      if (it < items) load_vec<X, V>(xs + int64_t(it / nv) * C + (it % nv) * V,
                                     v[u]);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (base + u * kThreads < items) m = merge(m, vector_moments<V>(v[u]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments o = {__shfl_xor_sync(0xffffffffu, m.n, off),
                 __shfl_xor_sync(0xffffffffu, m.mean, off),
                 __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = merge(m, o);
  }
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (tid == 0) {
    Moments t = warp_part[0];
    for (int w = 1; w < kThreads / 32; ++w) t = merge(t, warp_part[w]);
    block_part = t;
  }
  const uint32_t rank = cluster_ctarank();
  __syncwarp();
  if (S > 1) {
    cluster_sync();   // every block's partial is written
  } else {
    __syncthreads();
  }
  if (rank == 0 && tid == 0) {
    Moments t = block_part;
    const uint32_t part = smem_u32(&block_part);
    for (int r = 1; r < S; ++r) {
      const uint32_t p = map_to_rank(part, r);
      t = merge(t, Moments{ld_cluster_f32(p), ld_cluster_f32(p + 4),
                           ld_cluster_f32(p + 8)});
    }
    stats[0] = t.mean;
    stats[1] = 1.f / sqrtf(t.m2 / t.n + eps);
    if (mean_out != nullptr) {
      mean_out[b * G + g] = stats[0];
      rstd_out[b * G + g] = stats[1];
    }
  }
  __syncwarp();
  if (S > 1) {
    cluster_sync();   // block 0 has read every partial; the others may exit
  } else {
    __syncthreads();
  }
  if (rank != 0) return;
  const float mean = stats[0], rstd = stats[1];
  for (int c = tid; c < cg; c += kThreads) {
    const int ch = g * cg + c;
    float av = __fmul_rn(rstd, to_f(gamma[ch]));
    float bv = __fsub_rn(to_f(beta[ch]), __fmul_rn(mean, av));
    if (scale != nullptr) {
      const int64_t f = int64_t(b) * film_stride + ch;
      const float sc = __fadd_rn(1.f, to_f(scale[f]));
      av = __fmul_rn(av, sc);
      bv = __fadd_rn(__fmul_rn(bv, sc), to_f(shift[f]));
    }
    a_out[int64_t(b) * C + ch] = av;
    b_out[int64_t(b) * C + ch] = bv;
  }
}

template <typename X, typename P>
int launch(const void* x, const void* gamma, const void* beta,
           const void* scale, const void* shift, int film_stride, void* a,
           void* b, void* mean, void* rstd, int B, int Tlen, int C, int G,
           float eps, int splits, int vec, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, G, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  constexpr int V = 16 / sizeof(X);
  auto args = [&](auto kernel) {
    return cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const X*>(x), static_cast<const P*>(gamma),
        static_cast<const P*>(beta), static_cast<const P*>(scale),
        static_cast<const P*>(shift), film_stride, static_cast<float*>(a),
        static_cast<float*>(b), static_cast<float*>(mean),
        static_cast<float*>(rstd), Tlen, C, eps);
  };
  cudaError_t err = vec ? args(group_norm_affine_kernel<X, P, V>)
                        : args(group_norm_affine_kernel<X, P, 1>);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ns2vc

// x (B, T, C) contiguous, bf16 (x_bf16) or f32; gamma, beta (C,)
// contiguous and scale, shift (B, C) with rows film_stride elements apart
// (both null for no FiLM), bf16 (p_bf16) or f32; a, b (B, C) f32
// contiguous; mean, rstd (B, G) f32 contiguous, or both null. G divides
// C; `splits` (1..8) blocks per (batch, group) form a cluster, each over
// an equal run of frames. vec != 0: C / G is a multiple of 16 /
// sizeof(x's type) and x is 16-byte aligned. The caller guarantees 1 <=
// splits <= min(8, T), B, G <= 65535. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ns2vc_group_norm_affine(const void* x, const void* gamma,
                                       const void* beta, const void* scale,
                                       const void* shift, int film_stride,
                                       void* a, void* b, void* mean,
                                       void* rstd, int B, int Tlen, int C,
                                       int G, float eps, int splits,
                                       int x_bf16, int p_bf16, int vec,
                                       void* stream) {
  using ns2vc::bf16;
  using ns2vc::launch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kx, auto kp) {
    using X = decltype(kx);
    using P = decltype(kp);
    return launch<X, P>(x, gamma, beta, scale, shift, film_stride, a, b,
                        mean, rstd, B, Tlen, C, G, eps, splits, vec, st);
  };
  if (x_bf16) return p_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return p_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}
