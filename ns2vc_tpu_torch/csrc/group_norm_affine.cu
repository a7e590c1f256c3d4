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
// and the latency of its dependent steps weigh more than the bytes (a
// design with a serial merge and a second round trip for the parameters
// took ~5.4 us a launch against ~0.6 us of bytes at B = 16, PERF.md).
// What the design does about it: a grid of (S, G, B) blocks, S blocks per
// (batch, group) slab forming one thread block cluster; block s of the
// cluster reduces frames [s T / S, (s + 1) T / S) of the slab. The wrapper
// (`gn_threads`) sizes the block to the slab, a few hundred threads with one
// or two 16-byte vectors each (8 bf16 or 4 f32 of one row of the slab,
// when the group's channels come in whole vectors and x is 16-byte
// aligned, else single elements), with up to 8 loads in flight per thread
// for long slabs and S blocks where one block would need more than one
// round of them. The chain after the loads is short:
//   - each thread's values give their own mean (one division) and sum of
//     squared deviations from it, in registers (centred: a large common
//     offset loses no digits);
//   - (count, mean, M2) partials merge by Chan's pairwise rule, whose
//     weight is 1/2 without a division where the counts are equal (every
//     full thread's): a fixed xor-shuffle tree within each warp, one
//     barrier, then the same tree over the warps' partials in warp 0, and
//     for S > 1 over the cluster's blocks through distributed shared
//     memory, in warp 0 of block 0;
//   - warp 0 of block 0 loads its channels' gamma, beta and FiLM's scale
//     and shift while x is in flight, and folds them per channel in the
//     plain version's order of operations (no contraction into FMAs) as
//     soon as the statistics are known.
// The merge order is fixed by the indices alone: two launches on the same
// input give bitwise-equal a, b, with no atomics.
// Programmatic dependent launch (kPdl, hopper.cuh): the kernel is launched
// with the programmatic stream serialization attribute and reads nothing
// before `grid_dependency_wait` (any input, gamma and beta too, may come
// from the kernel before it: a cast, a copy, an optimizer's update); once
// its loads of x are done it lets the K2 conv after it (launched the same
// way) start, whose barriers and weight copies then overlap this kernel's
// merge and fold.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;   // gn_threads' largest block
constexpr int kLoads = 8;          // vectors in flight per thread at most
constexpr int kPre = 2;            // channels per lane prefetched for the fold

struct Moments {
  float n, mean, m2;   // count, mean, sum of squared deviations
};

// Chan et al.'s pairwise merge of two partial moments; equal counts (every
// full thread's, warp's and block's partials) take the weight 1/2 exactly,
// which is what b.n / n gives them, without the division
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float wb = a.n == b.n ? 0.5f : b.n / n;
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

// a fixed xor-shuffle tree over the warp: lane 0 ends with the warp's total
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o = {__shfl_xor_sync(0xffffffffu, m.n, off),
                       __shfl_xor_sync(0xffffffffu, m.mean, off),
                       __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

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

// channel ch's a and b from the slab's mean and rstd, in the plain
// version's order of operations
__device__ __forceinline__ void fold(float mean, float rstd, float gm,
                                     float bt, bool film, float sc_in,
                                     float sh, float& av, float& bv) {
  av = __fmul_rn(rstd, gm);
  bv = __fsub_rn(bt, __fmul_rn(mean, av));
  if (film) {
    const float sc = __fadd_rn(1.f, sc_in);
    av = __fmul_rn(av, sc);
    bv = __fadd_rn(__fmul_rn(bv, sc), sh);
  }
}

template <typename X, typename P, int V>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_affine_kernel(const X* __restrict__ x, const P* __restrict__ gamma,
                         const P* __restrict__ beta,
                         const P* __restrict__ scale,
                         const P* __restrict__ shift, int film_stride,
                         float* __restrict__ a_out, float* __restrict__ b_out,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int Tlen, int C,
                         float eps) {
  __shared__ Moments warp_part[kMaxThreads / 32];
  __shared__ Moments block_part;

  const int S = gridDim.x, s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.y, cg = C / G, nv = cg / V;
  const int threads = blockDim.x, nwarps = threads >> 5;
  const int t_lo = int(int64_t(s) * Tlen / S);
  const int t_hi = int(int64_t(s + 1) * Tlen / S);
  const int items = (t_hi - t_lo) * nv;
  const X* xs = x + (int64_t(b) * Tlen + t_lo) * C + g * cg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = cluster_ctarank();
  const bool folder = rank == 0 && warp == 0;
  const bool film = scale != nullptr;

  if constexpr (kPdl) grid_dependency_wait();
  // the fold's parameters of this lane's channels, in flight with x
  float gp[kPre], bp[kPre], sp[kPre], hp[kPre];
  if (folder) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int c = lane + 32 * i;
      const int64_t f = int64_t(b) * film_stride + g * cg + c;
      gp[i] = c < cg ? to_f(gamma[g * cg + c]) : 0.f;
      bp[i] = c < cg ? to_f(beta[g * cg + c]) : 0.f;
      sp[i] = film && c < cg ? to_f(scale[f]) : 0.f;
      hp[i] = film && c < cg ? to_f(shift[f]) : 0.f;
    }
  }

  Moments m = {0.f, 0.f, 0.f};
  for (int base = tid; base < items; base += threads * kLoads) {
    float v[kLoads][V];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int it = base + u * threads;
      if (it < items) load_vec<X, V>(xs + int64_t(it / nv) * C + (it % nv) * V,
                                     v[u]);
    }
    // this round's values: their mean, then their squared deviations
    const int cnt = min(kLoads, (items - base + threads - 1) / threads);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (u < cnt)
#pragma unroll
        for (int i = 0; i < V; ++i) sum += v[u][i];
    const float n = float(cnt * V), mean = sum / n;
    float m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (u < cnt)
#pragma unroll
        for (int i = 0; i < V; ++i)
          m2 = fmaf(v[u][i] - mean, v[u][i] - mean, m2);
    m = merge(m, Moments{n, mean, m2});
  }
  if constexpr (kPdl) launch_dependents();   // x is read

  m = warp_merge(m);
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_merge(lane < nwarps ? warp_part[lane] : Moments{0.f, 0.f, 0.f});
    if (S > 1 && lane == 0) block_part = m;
  }
  if (S > 1) {
    cluster_sync();   // every block's partial is written
    if (folder) {
      Moments r = {0.f, 0.f, 0.f};
      if (lane < S) {
        const uint32_t p = map_to_rank(smem_u32(&block_part), lane);
        r = Moments{ld_cluster_f32(p), ld_cluster_f32(p + 4),
                    ld_cluster_f32(p + 8)};
      }
      m = warp_merge(r);
    }
  }
  if (folder) {
    const float mean = __shfl_sync(0xffffffffu, m.mean, 0);
    const float rstd =
        __shfl_sync(0xffffffffu, 1.f / sqrtf(m.m2 / m.n + eps), 0);
    if (lane == 0 && mean_out != nullptr) {
      mean_out[b * G + g] = mean;
      rstd_out[b * G + g] = rstd;
    }
    float* ar = a_out + int64_t(b) * C + g * cg;
    float* br = b_out + int64_t(b) * C + g * cg;
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int c = lane + 32 * i;
      if (c < cg) fold(mean, rstd, gp[i], bp[i], film, sp[i], hp[i], ar[c],
                       br[c]);
    }
    for (int c = lane + 32 * kPre; c < cg; c += 32) {   // wider groups
      const int64_t f = int64_t(b) * film_stride + g * cg + c;
      fold(mean, rstd, to_f(gamma[g * cg + c]), to_f(beta[g * cg + c]), film,
           film ? to_f(scale[f]) : 0.f, film ? to_f(shift[f]) : 0.f, ar[c],
           br[c]);
    }
  }
  if (S > 1) cluster_sync();   // block 0 has read every partial
}

template <typename X, typename P>
int launch(const void* x, const void* gamma, const void* beta,
           const void* scale, const void* shift, int film_stride, void* a,
           void* b, void* mean, void* rstd, int B, int Tlen, int C, int G,
           float eps, int splits, int threads, int vec, cudaStream_t st) {
  if (splits < 1 || splits > 8 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return int(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(X);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, G, B);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  // programmatic dependent launch; a cluster only where a slab is split
  cudaLaunchAttribute attr[2];
  attr[0] = pdl_attribute();
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = splits;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = kPdl ? attr : attr + 1;
  cfg.numAttrs = (kPdl ? 1 : 0) + (splits > 1 ? 1 : 0);
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
// an equal run of frames, of `threads` threads (whole warps, 32..512; the
// merge order follows from it and the shape alone). vec != 0: C / G is a multiple of 16 /
// sizeof(x's type) and x is 16-byte aligned. The caller guarantees splits
// <= T, B, G <= 65535. Returns the CUDA error of the launch (0 on
// success).
extern "C" int ns2vc_group_norm_affine(const void* x, const void* gamma,
                                       const void* beta, const void* scale,
                                       const void* shift, int film_stride,
                                       void* a, void* b, void* mean,
                                       void* rstd, int B, int Tlen, int C,
                                       int G, float eps, int splits,
                                       int threads, int x_bf16, int p_bf16,
                                       int vec,
                                       void* stream) {
  using ns2vc::bf16;
  using ns2vc::launch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kx, auto kp) {
    using X = decltype(kx);
    using P = decltype(kp);
    return launch<X, P>(x, gamma, beta, scale, shift, film_stride, a, b,
                        mean, rstd, B, Tlen, C, G, eps, splits, threads,
                        vec, st);
  };
  if (x_bf16) return p_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return p_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}
