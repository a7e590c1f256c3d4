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
// 3.35 TB/s, so a call is launch and load latency as much as bytes.
// What the design does about it: it never rereads x for statistics (mean
// and rstd come from the forward) and writes dx as one affine map of x per
// (batch, group), in two kernels of one launch call:
//   - `coef`, one block of 32 warps per group: lane l takes the group's
//     channels l, l + 32, ..., warp w the batch rows w, w + 32, ...; each
//     (b, c) gives dscale, dshift and its terms; dr and dm of a batch row
//     are summed over its channels by xor shuffles within the warp, and
//     thread 0 of the warp writes the row's (dm / N, 2 dvar / N, m);
//     dgamma and dbeta of a channel are summed over the batch rows, per
//     warp in order of b, then over the warps in order through shared
//     memory, by one thread per channel;
//   - `dx`, a streaming pass over x: each thread reads GN_BWD_VECS 16-byte
//     vectors (8 bf16 or 4 f32 of one group) before it writes any, or
//     single elements where the group's channels are not whole vectors or
//     x is not 16-byte aligned; the coefficients come through the L1 cache.
// Every sum runs in an order fixed by the shapes, with no atomics: two
// launches on one input give bitwise-equal gradients.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kCoefWarps = 32;
constexpr int kDxThreads = 256;
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

template <typename P>
__global__ void __launch_bounds__(kCoefWarps * 32)
gn_bwd_coef_kernel(const P* __restrict__ gamma, const P* __restrict__ beta,
                   const P* __restrict__ scale, int film_stride,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd,
                   const float* __restrict__ da, const float* __restrict__ db,
                   P* __restrict__ dgamma, P* __restrict__ dbeta,
                   P* __restrict__ dscale, P* __restrict__ dshift,
                   float4* __restrict__ coef, int B, int Tlen, int C) {
  __shared__ float part[2][kCoefWarps][33];
  const int g = blockIdx.x, G = gridDim.x, cg = C / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float n = float(Tlen) * float(cg);
  for (int c0 = 0; c0 < cg; c0 += 32) {
    const int c = g * cg + c0 + lane;
    const bool on = c0 + lane < cg;
    const float gc = on ? to_f(gamma[c]) : 0.f;
    const float bc = on ? to_f(beta[c]) : 0.f;
    float pg = 0.f, pb = 0.f;   // this thread's share of dgamma_c, dbeta_c
    for (int b = warp; b < B; b += kCoefWarps) {
      const float m = mean[b * G + g], r = rstd[b * G + g];
      float dr = 0.f, dm = 0.f;
      if (on) {
        const int64_t at = int64_t(b) * C + c;
        const float dav = da[at], dbv = db[at];
        const float s =
            scale != nullptr
                ? __fadd_rn(1.f, to_f(scale[int64_t(b) * film_stride + c]))
                : 1.f;
        const float t = dav - m * dbv;
        dr = gc * s * t;
        dm = r * gc * s * dbv;
        pg += r * s * t;
        pb += dbv * s;
        if (scale != nullptr) {
          const float rg = r * gc;
          dscale[at] = from_f<P>(dav * rg + dbv * (bc - m * rg));
          dshift[at] = from_f<P>(dbv);
        }
      }
      // the row's sums over this chunk's channels, then the earlier
      // chunks' (kept in coef by lane 0, in order of the chunks)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dr += __shfl_xor_sync(0xffffffffu, dr, off);
        dm += __shfl_xor_sync(0xffffffffu, dm, off);
      }
      if (lane == 0) {
        float4 k = c0 == 0 ? make_float4(0.f, 0.f, m, 0.f)
                           : coef[b * G + g];
        k.x += dr;   // dr, dm summed so far (finished below)
        k.y += dm;
        if (c0 + 32 >= cg) {   // the last chunk: the row's coefficients
          const float dvar = -0.5f * r * r * r * k.x;
          k = make_float4(-k.y / n, 2.f * dvar / n, m, 0.f);
        }
        coef[b * G + g] = k;
      }
    }
    part[0][warp][lane] = pg;
    part[1][warp][lane] = pb;
    __syncthreads();
    if (warp == 0 && on) {
      float sg = part[0][0][lane], sb = part[1][0][lane];
      for (int w = 1; w < kCoefWarps; ++w) {
        sg += part[0][w][lane];
        sb += part[1][w][lane];
      }
      dgamma[c] = from_f<P>(sg);
      dbeta[c] = from_f<P>(sb);
    }
    __syncthreads();
  }
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

template <typename X, int V>
__global__ void __launch_bounds__(kDxThreads)
gn_bwd_dx_kernel(const X* __restrict__ x, const float4* __restrict__ coef,
                 X* __restrict__ dx, int64_t nvec, int TC, int C, int cg,
                 int G) {
  const int64_t base = int64_t(blockIdx.x) * kDxThreads * kDxVecs +
                       threadIdx.x;
  float v[kDxVecs][V];
#pragma unroll
  for (int u = 0; u < kDxVecs; ++u) {
    const int64_t i = base + u * kDxThreads;
    if (i < nvec) load_vec<X, V>(x + i * V, v[u]);
  }
#pragma unroll
  for (int u = 0; u < kDxVecs; ++u) {
    const int64_t i = base + u * kDxThreads;
    if (i >= nvec) continue;
    const int64_t e = i * V;
    const int b = int(e / TC), c = int(e % C);
    const float4 k = __ldg(coef + b * G + c / cg);
#pragma unroll
    for (int j = 0; j < V; ++j) v[u][j] = fmaf(k.y, v[u][j] - k.z, k.x);
    store_vec<X, V>(dx + e, v[u]);
  }
}

template <typename X, typename P>
int launch(const void* x, const void* gamma, const void* beta,
           const void* scale, int film_stride, const float* mean,
           const float* rstd, const float* da, const float* db, void* dx,
           void* dgamma, void* dbeta, void* dscale, void* dshift, void* coef,
           int B, int Tlen, int C, int G, int dx_blocks, int vec,
           cudaStream_t st) {
  gn_bwd_coef_kernel<P><<<G, kCoefWarps * 32, 0, st>>>(
      static_cast<const P*>(gamma), static_cast<const P*>(beta),
      static_cast<const P*>(scale), film_stride, mean, rstd, da, db,
      static_cast<P*>(dgamma), static_cast<P*>(dbeta),
      static_cast<P*>(dscale), static_cast<P*>(dshift),
      static_cast<float4*>(coef), B, Tlen, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return int(err);
  constexpr int V = 16 / sizeof(X);
  const int64_t n = int64_t(B) * Tlen * C;
  auto go = [&](auto kernel, int width) {
    kernel<<<dx_blocks, kDxThreads, 0, st>>>(
        static_cast<const X*>(x), static_cast<const float4*>(coef),
        static_cast<X*>(dx), n / width, Tlen * C, C, C / G, G);
  };
  if (vec) {
    go(gn_bwd_dx_kernel<X, V>, V);
  } else {
    go(gn_bwd_dx_kernel<X, 1>, 1);
  }
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ns2vc

// x (B, T, C) contiguous, bf16 (x_bf16) or f32; gamma, beta (C,)
// contiguous and scale (B, C) rows film_stride elements apart (null for no
// FiLM; shift is not read: its gradient is db), bf16 (p_bf16) or f32;
// mean, rstd (B, G), da, db (B, C) f32 contiguous; dx (null: not computed)
// in x's type; dgamma, dbeta (C,), dscale, dshift (B, C) contiguous (null
// without FiLM) in the parameters' type; coef: 4 B G f32 of workspace.
// `dx_blocks` blocks of the dx kernel cover B T C values in vectors of 16
// bytes (vec != 0: C / G a multiple of 16 / sizeof(x's type), x 16-byte
// aligned) or single values, GN_BWD_VECS per thread of 256. The caller
// guarantees G divides C, B, G <= 65535. Returns the CUDA error of the
// launches (0 on success).
extern "C" int ns2vc_group_norm_affine_bwd(
    const void* x, const void* gamma, const void* beta, const void* scale,
    const void* shift, int film_stride, const void* mean, const void* rstd,
    const void* da, const void* db, void* dx, void* dgamma, void* dbeta,
    void* dscale, void* dshift, void* coef, int B, int Tlen, int C, int G,
    int dx_blocks, int x_bf16, int p_bf16, int vec, void* stream) {
  using ns2vc::bf16;
  using ns2vc::launch;
  (void)shift;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kx, auto kp) {
    using X = decltype(kx);
    using P = decltype(kp);
    return launch<X, P>(x, gamma, beta, scale, film_stride,
                        static_cast<const float*>(mean),
                        static_cast<const float*>(rstd),
                        static_cast<const float*>(da),
                        static_cast<const float*>(db), dx, dgamma, dbeta,
                        dscale, dshift, coef, B, Tlen, C, G, dx_blocks, vec,
                        st);
  };
  if (x_bf16) return p_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return p_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}
