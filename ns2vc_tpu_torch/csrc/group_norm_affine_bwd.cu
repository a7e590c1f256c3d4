// Backward of the GroupNorm statistics and fold (group_norm_affine.cu) on
// Hopper (sm_90a): given the gradients da, db (B, C) f32 of
//     a = r g s,  b = (beta - m r g) s + shift,  s = 1 + scale (or 1),
// with r, m each (batch, group)'s rstd and mean as the forward kept them
// (B, G) f32, it computes, in the plain version's closed form
// (ops/fused_resnet.py::group_norm_affine_backward):
//     dshift = db,  dscale = da r g + db (beta - m r g)
//     dbeta_c = sum_b db s,  dgamma_c = sum_b r s (da - m db)
//     dr = sum_{c in G} g s (da - m db),  dm = -sum_{c in G} r g s db
//     dx = dm / N + 2 dvar (x - m) / N,  dvar = -r^3 dr / 2,  N = T C / G.
// x, dx (B, T, C) bf16 or f32 contiguous; gamma, beta (C,), scale, shift
// (B, C) rows `film_stride` apart, f32 or bf16 (one dtype for the four),
// and their gradients in that dtype, dscale, dshift contiguous.
//
// Replaces: the autograd recompute of the plain version (an f32 copy of x,
// var_mean, two repeat_interleaves and about a dozen more launches per
// call: 139 us a call at a Config() training step), and through it XLA's
// autodiff of the fold at ns2vc_tpu/ops/pallas_resnet.py:121-130, which
// the JAX package trains through.
//
// What bounds it on the H100: bytes. x is read once and dx written once;
// every other tensor is (B, C) or (C,). At the training step's calls (32 x
// 272, C = 128..1024 in bf16) that is 4.5 MB a call at most: ~1.3 us at
// 3.35 TB/s, so a call is launch and load latency as much as bytes: a
// launch costs ~2 us in a CUDA graph, and a second kernel that waits for
// the first's coefficients another launch and another round of loads.
// What the design does about it: one launch per call over all SMs, which
// never rereads x for statistics (mean and rstd come from the forward).
// Its grid holds two kinds of block, told apart by their index:
//   - parameter blocks (the first ceil(C / 32)): 32 channels each, lane l
//     the channel, warp w the batch rows w, w + 8, ...; each (b, c) gives
//     dscale, dshift and its terms of dgamma_c, dbeta_c, summed per warp in
//     order of b, then over the 8 warps in order through shared memory;
//   - dx blocks (`row_blocks` per batch row b, each a contiguous run of
//     that row's T C values): each issues its first loads of x, then
//     derives the row's coefficients itself (warp w the groups w, w + 8,
//     ...; lane l the group's channels l, l + 32, ...; summed over the
//     lanes by xor shuffles: dr, dm, then (dm / N, 2 dvar / N, m) per group
//     into shared memory), then writes dx as one affine map of x per group:
//     16-byte vectors (8 bf16 or 4 f32 of one group), GN_BWD_VECS in
//     flight per thread, or single elements where the group's channels are
//     not whole vectors or x is not 16-byte aligned.
// A row's coefficients are B x C values read from the L2 cache, about one
// vector round's bytes of the block; they replace a kernel of 8 blocks
// that merged the 32 warps one thread per channel. The launch is
// programmatic (kPdl): it may start while the kernel before it (in the
// step K2's backward, whose finalize writes da and db; in a direct call
// whatever came last, which may have written any input) ends; every block
// reads and writes anything only after `grid_dependency_wait`. Every sum
// runs in an order fixed by the shapes, with no atomics: two launches on
// one input give bitwise-equal gradients.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDxVecs = 4;   // vectors in flight per thread (GN_BWD_VECS)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
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

template <typename X, int V>
__device__ __forceinline__ void store_vec(X* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<X>(v[0]);
  } else {
    uint4 raw;
    X* e = reinterpret_cast<X*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<X>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <typename P>
struct Args {
  const void* x;
  const P *gamma, *beta, *scale;
  int film_stride;
  const float *mean, *rstd, *da, *db;
  void* dx;
  P *dgamma, *dbeta, *dscale, *dshift;
  int B, Tlen, C, G, param_blocks, row_blocks;
};

// dscale, dshift of 32 channels at every batch row, and their dgamma,
// dbeta: warp w sums the rows w, w + 8, ... in order, then the warps' sums
// are added in order of w
template <typename P>
__device__ void param_block(const Args<P>& a, int c0) {
  __shared__ float part[2][kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + lane, cg = a.C / a.G;
  const bool on = c < a.C;
  float pg = 0.f, pb = 0.f;
  if (on) {
    const int g = c / cg;
    const float gc = to_f(a.gamma[c]), bc = to_f(a.beta[c]);
#pragma unroll 4
    for (int b = warp; b < a.B; b += kWarps) {
      const float m = a.mean[b * a.G + g], r = a.rstd[b * a.G + g];
      const int64_t at = int64_t(b) * a.C + c;
      const float dav = a.da[at], dbv = a.db[at];
      const float s =
          a.scale != nullptr
              ? __fadd_rn(1.f, to_f(a.scale[int64_t(b) * a.film_stride + c]))
              : 1.f;
      pg += r * s * (dav - m * dbv);
      pb += dbv * s;
      if (a.scale != nullptr) {
        const float rg = r * gc;
        a.dscale[at] = from_f<P>(dav * rg + dbv * (bc - m * rg));
        a.dshift[at] = from_f<P>(dbv);
      }
    }
  }
  part[0][warp][lane] = pg;
  part[1][warp][lane] = pb;
  __syncthreads();
  if (warp == 0 && on) {
    float sg = part[0][0][lane], sb = part[1][0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      sg += part[0][w][lane];
      sb += part[1][w][lane];
    }
    a.dgamma[c] = from_f<P>(sg);
    a.dbeta[c] = from_f<P>(sb);
  }
}

// batch row b's per-group coefficients (dm / N, 2 dvar / N, m) into coef
template <typename P>
__device__ void row_coefficients(const Args<P>& a, int b, float4* coef) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = a.C / a.G;
  const float n = float(a.Tlen) * float(cg);
  for (int g = warp; g < a.G; g += kWarps) {
    const float m = a.mean[b * a.G + g], r = a.rstd[b * a.G + g];
    float dr = 0.f, dm = 0.f;
#pragma unroll 4
    for (int j = lane; j < cg; j += 32) {
      const int c = g * cg + j;
      const int64_t at = int64_t(b) * a.C + c;
      const float dbv = a.db[at];
      const float s =
          a.scale != nullptr
              ? __fadd_rn(1.f, to_f(a.scale[int64_t(b) * a.film_stride + c]))
              : 1.f;
      const float gs = to_f(a.gamma[c]) * s;
      dr += gs * (a.da[at] - m * dbv);
      dm += r * gs * dbv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dr += __shfl_xor_sync(0xffffffffu, dr, off);
      dm += __shfl_xor_sync(0xffffffffu, dm, off);
    }
    if (lane == 0) {
      const float dvar = -0.5f * r * r * r * dr;
      coef[g] = make_float4(-dm / n, 2.f * dvar / n, m, 0.f);
    }
  }
}

// this thread's vectors of one round (kDxVecs x kThreads vectors from
// vector `first`, below `end`) of batch row b
template <typename X, int V>
__device__ __forceinline__ void load_round(const X* xrow, int64_t first,
                                           int64_t end,
                                           float (&v)[kDxVecs][V]) {
#pragma unroll
  for (int u = 0; u < kDxVecs; ++u) {
    const int64_t i = first + u * kThreads + threadIdx.x;
    if (i < end) load_vec<X, V>(xrow + i * V, v[u]);
  }
}

template <typename X, int V>
__device__ __forceinline__ void store_round(X* dxrow, int64_t first,
                                            int64_t end, int C, int cg,
                                            const float4* coef,
                                            float (&v)[kDxVecs][V]) {
#pragma unroll
  for (int u = 0; u < kDxVecs; ++u) {
    const int64_t i = first + u * kThreads + threadIdx.x;
    if (i >= end) continue;
    const int64_t e = i * V;
    const float4 k = coef[int(e % C) / cg];
#pragma unroll
    for (int j = 0; j < V; ++j) v[u][j] = fmaf(k.y, v[u][j] - k.z, k.x);
    store_vec<X, V>(dxrow + e, v[u]);
  }
}

template <typename X, typename P, int V>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const __grid_constant__ Args<P> a) {
  extern __shared__ float4 coef[];   // G per-group coefficients
  if (int(blockIdx.x) < a.param_blocks) {
    if constexpr (kPdl) grid_dependency_wait();
    param_block(a, blockIdx.x * 32);
    return;
  }
  const int j = blockIdx.x - a.param_blocks;
  const int b = j / a.row_blocks, part = j % a.row_blocks;
  // this block's vectors of the row: rounds [r0, r1) of kDxVecs x kThreads
  const int64_t per_row = int64_t(a.Tlen) * a.C / V;
  constexpr int kRound = kDxVecs * kThreads;
  const int64_t rounds = (per_row + kRound - 1) / kRound;
  const int64_t r0 = rounds * part / a.row_blocks,
                r1 = rounds * (part + 1) / a.row_blocks;
  const int64_t end = per_row;
  const X* xrow = static_cast<const X*>(a.x) + int64_t(b) * a.Tlen * a.C;
  X* dxrow = static_cast<X*>(a.dx) + int64_t(b) * a.Tlen * a.C;
  float v[kDxVecs][V];
  if constexpr (kPdl) grid_dependency_wait();
  // the first round of x in flight while the coefficients load
  if (r0 < r1) load_round<X, V>(xrow, r0 * kRound, end, v);
  row_coefficients(a, b, coef);
  __syncthreads();
  const int cg = a.C / a.G;
  for (int64_t r = r0; r < r1; ++r) {
    if (r > r0) load_round<X, V>(xrow, r * kRound, end, v);
    store_round<X, V>(dxrow, r * kRound, end, a.C, cg, coef, v);
  }
}

template <typename X, typename P>
int launch(const Args<P>& a, int vec, cudaStream_t st) {
  constexpr int V = 16 / sizeof(X);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.param_blocks + (a.dx ? a.B * a.row_blocks : 0));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.G * sizeof(float4);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0] = pdl_attribute();
  cfg.attrs = attr;
  cfg.numAttrs = kPdl ? 1 : 0;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, gn_bwd_kernel<X, P, V>, a)
          : cudaLaunchKernelEx(&cfg, gn_bwd_kernel<X, P, 1>, a);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace
}  // namespace ns2vc

// x (B, T, C) contiguous, bf16 (x_bf16) or f32; gamma, beta (C,)
// contiguous and scale (B, C) rows film_stride elements apart (null for no
// FiLM; shift is not read: its gradient is db), bf16 (p_bf16) or f32;
// mean, rstd (B, G), da, db (B, C) f32 contiguous; dx (null: not computed)
// in x's type; dgamma, dbeta (C,), dscale, dshift (B, C) contiguous (null
// without FiLM) in the parameters' type. One launch of ceil(C / 32)
// parameter blocks and, with dx, `row_blocks` dx blocks per batch row,
// each over an even share of the row's rounds of GN_BWD_VECS 16-byte
// vectors (vec != 0: C / G a multiple of 16 / sizeof(x's type), x 16-byte
// aligned) or single values per thread of 256. The caller guarantees G
// divides C, G <= 3072 (the coefficients' shared memory), and the grid
// within 2^31 - 1 blocks. Returns the CUDA error of the launch (0 on
// success).
extern "C" int ns2vc_group_norm_affine_bwd(
    const void* x, const void* gamma, const void* beta, const void* scale,
    const void* shift, int film_stride, const void* mean, const void* rstd,
    const void* da, const void* db, void* dx, void* dgamma, void* dbeta,
    void* dscale, void* dshift, int B, int Tlen, int C, int G, int row_blocks,
    int x_bf16, int p_bf16, int vec, void* stream) {
  using ns2vc::bf16;
  (void)shift;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kx, auto kp) {
    using X = decltype(kx);
    using P = decltype(kp);
    const ns2vc::Args<P> a{x,
                           static_cast<const P*>(gamma),
                           static_cast<const P*>(beta),
                           static_cast<const P*>(scale),
                           film_stride,
                           static_cast<const float*>(mean),
                           static_cast<const float*>(rstd),
                           static_cast<const float*>(da),
                           static_cast<const float*>(db),
                           dx,
                           static_cast<P*>(dgamma),
                           static_cast<P*>(dbeta),
                           static_cast<P*>(dscale),
                           static_cast<P*>(dshift),
                           B,
                           Tlen,
                           C,
                           G,
                           (C + 31) / 32,
                           row_blocks};
    return ns2vc::launch<X, P>(a, vec, st);
  };
  if (x_bf16) return p_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return p_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}
