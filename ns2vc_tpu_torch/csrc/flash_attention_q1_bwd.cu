// Single-query attention backward, f32 or bf16: given
//     o = softmax(q . k^T * scale + key_bias) . v,   Tq = 1,
// and o's gradient dO, it computes
//     P = softmax(q . k^T * scale + key_bias)     (recomputed, f32)
//     dP_j = dO . v_j,  Delta = sum_j P_j dP_j,  dS_j = P_j (dP_j - Delta)
//     dv_j = P_j dO     (P rounded to v's dtype, as the PV product takes it)
//     dk_j = dS_j q scale,  dq = scale sum_j dS_j k_j
// q, dO (B, H, 1, D), k, v (B, H, Tk, D), any D <= 128, through (batch,
// head, seq) strides; the key bias (B, Tk) f32 or none; dq, dk, dv through
// their strides (the wrapper's (B, T, H, D) buffers).
//
// Replaces: the torch-ops backward `ops/flash_attention.py::
// flash_attention_backward` (the plain version) for calls of one query,
// and through it XLA's autodiff of ns2vc_tpu/ops/attention.py::
// scaled_dot_product_attention, the function the Pallas TPU kernel
// ns2vc_tpu/ops/pallas_attention.py::flash_attention computes (forward
// only). Its calls: the two attention pools of every training step
// (`ref_enc`, 1 head x 1 query over 273 keys x D = 100, and the UNet's
// `add_embedding`, 64 heads x 4), in bf16, and in f32 in the f32 gradient
// checks.
//
// What bounds it on the H100: bytes. k and v are read once and dk and dv
// written once (~7 MB at B = 32 x 273 keys for `add_embedding`, 2 us at
// 3.35 TB/s) against ~8 H Tk D flops; at these sizes a call is a few
// memory round trips and the dependent steps between them.
// Design, the forward's plan (flash_attention_q1.cu): blocks of 256
// threads per (batch row, group of heads, share of the keys), planned by
// `plan_q1_backward` so that the grid is one wave on the card's SMs where
// the heads and keys allow it, the shares of one (batch row, group) a
// thread block cluster of up to 8. A block's k and v rows (its heads' H_g x
// D values of each key: one contiguous segment where the heads lie side by
// side) arrive by cp.async in the widest vector the alignment of every
// tensor allows (16, 8 or 4 bytes; else element loads), a tile of k and
// one of v per stage; where a share fits one stage (both pools) k is read
// once for both passes. Pass 1: each (head, key) pair's logit and dP, f32
// dot products by a power-of-two group of lanes reduced by shuffles, kept
// in shared memory. Then per head (a warp each): the share's max m, l =
// sum 2^(x - m) and u = sum 2^(x - m) dP (lanes, then xor shuffles); one
// cluster barrier; every rank's (m, l, u) read through distributed shared
// memory by a lane each, all in flight together, rescaled to the cluster's
// max and added in rank order; lse = m + log2(l), Delta = u / l, so Delta
// is the sum of this kernel's own P and dP (each dS row sums to zero up to
// f32 rounding). Pass 2: P and dS per pair, then dk and dv rows written as
// vectors, and dq's share over the block's keys: per output element a
// group of threads over keys (g mod G), the groups added in order, then
// the cluster's blocks in rank order through distributed shared memory.
// Every sum runs in an order fixed by the shapes and no atomics are used,
// so two launches on one input give bitwise-equal outputs.
#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

template <int VB>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(VB));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, bf16) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// N = VB / sizeof(T) values to p as one VB-byte store (one element below
// 4 bytes), each rounded to T as from_f32 rounds it
template <typename T, int VB, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[N]) {
  if constexpr (VB < 4) {
    *p = from_f32<T>(v[0]);
  } else {
    uint32_t w[VB / 4];
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(v[i]);
      } else {
        w[i] = pack_bf16x2(v[2 * i], v[2 * i + 1]);
      }
    }
    if constexpr (VB == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VB == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// The shared memory (floats) of a block of `hg` heads of D over `kpb` keys
// before its stages: q, dO and the dq partial (hg D each), logits -> P and
// dP -> dS (hg kpb each), the dq shares (kThreads), and per head the
// share's max, l and u and two spares, 16-byte aligned.
// `q1_backward_smem` in ops/flash_attention.py mirrors it.
__host__ __device__ inline int q1b_floats(int hg, int D, int kpb) {
  return (3 * hg * D + 2 * hg * kpb + kThreads + 5 * hg + 3) & ~3;
}

__device__ __forceinline__ void cluster_or_block_sync(int splits) {
  if (splits > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

template <typename T>
struct Q1Args {
  const T *q, *k, *v, *dout;
  const float* bias;
  T *dq, *dk, *dv;
  int H, Tk, D, hg_max, tile, splits;
  // (batch, head, seq) element strides of q, k, v, dO, dq, dk, dv
  int64_t s[21];
  float scale_log2, scale;
};

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q1_kernel(const __grid_constant__ Q1Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVec = VB / int(sizeof(T));   // elements per load and store
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int splits = a.splits, D = a.D, Tk = a.Tk, tile = a.tile;
  const int split = int(blockIdx.x) % splits;   // its rank in the cluster
  const int b = blockIdx.y, h0 = (blockIdx.x / splits) * a.hg_max;
  const int hg = min(a.hg_max, a.H - h0);
  const int W = hg * D;                          // this block's row segment
  const int kpb = (Tk + splits - 1) / splits;
  const int kb = split * kpb, ke = min(Tk, kb + kpb), n = ke - kb;
  const int64_t* s = a.s;
  const int stage_elems = 2 * tile * a.hg_max * D;   // a k tile, a v tile
  float* qs = smem;                          // W
  float* dos = qs + a.hg_max * D;            // W
  float* part = dos + a.hg_max * D;          // W: the block's dq partial
  float* X = part + a.hg_max * D;            // hg kpb: logits, then P
  float* DP = X + a.hg_max * kpb;            // hg kpb: dP, then dS
  float* red = DP + a.hg_max * kpb;          // kThreads dq shares
  float* mstat = red + kThreads;             // hg: the share's max
  float* lstat = mstat + a.hg_max;           // hg: the share's l
  float* ustat = lstat + a.hg_max;           // hg: the share's u
  T* stg = reinterpret_cast<T*>(smem + q1b_floats(a.hg_max, D, kpb));

  // load i: tile i of k and of v (i < nt), else tile i - nt of k alone
  // (pass 2, when the share takes more than one tile), into stage i %
  // kStages; whole vectors of kVec (the wrapper checked every segment,
  // offset and stride)
  const int nt = (n + tile - 1) / tile;
  const int total = nt == 1 ? 1 : 2 * nt;
  const int per_row = W / kVec;
  auto issue = [&](int i) {
    if (i >= total) return;
    const int j0 = kb + (i % nt) * tile, nk = min(tile, ke - j0);
    T* dst = stg + (i % kStages) * stage_elems;
    for (int m = 0; m < (i < nt ? 2 : 1); ++m) {
      const T* src = m == 0 ? a.k : a.v;
      const int64_t sb = s[3 + 3 * m], sh = s[4 + 3 * m], st = s[5 + 3 * m];
      T* dm = dst + m * tile * a.hg_max * D;
      for (int c = tid; c < nk * per_row; c += kThreads) {
        const int jj = c / per_row, e = (c - jj * per_row) * kVec;
        const int h = e / D;
        const T* p = src + b * sb + (h0 + h) * sh + (j0 + jj) * st + (e - h * D);
        T* d = dm + jj * W + e;
        if constexpr (VB >= 4) {
          cp_async_ca<VB>(smem_u32(d), p);
        } else {
          *d = *p;
        }
      }
    }
  };

  // pass 1 over a tile: each (head, key) pair's logit (log2 domain) and dP
  // by `tpp` lanes
  int tpp = 1;
  while (tpp < 32 && 2 * tpp * hg * min(tile, n) <= kThreads) tpp *= 2;
  auto dots = [&](const T* kt, const T* vt, int j0, int nk) {
    const int npair = hg * nk, per = kThreads / tpp, sub = tid % tpp;
    for (int p0 = 0; p0 < npair; p0 += per) {   // the same trip count for all
      const int p = p0 + tid / tpp, jj = p / hg, h = p - jj * hg;
      float sk = 0.f, sv = 0.f;
      if (p < npair) {
        const T* kr = kt + jj * W + h * D;
        const T* vr = vt + jj * W + h * D;
        const float* qh = qs + h * D;
        const float* dh = dos + h * D;
#pragma unroll 4
        for (int d = sub; d < D; d += tpp) {
          sk = fmaf(qh[d], to_f32(kr[d]), sk);
          sv = fmaf(dh[d], to_f32(vr[d]), sv);
        }
      }
      for (int off = tpp / 2; off > 0; off >>= 1) {
        sk += __shfl_xor_sync(0xffffffffu, sk, off);
        sv += __shfl_xor_sync(0xffffffffu, sv, off);
      }
      if (p < npair && sub == 0) {
        const int at = h * kpb + j0 - kb + jj;
        X[at] = a.bias != nullptr
                    ? fmaf(sk, a.scale_log2, a.bias[int64_t(b) * Tk + j0 + jj] * kLog2e)
                    : sk * a.scale_log2;
        DP[at] = sv;
      }
    }
  };

  // per head (a warp each): the share's max m, l = sum 2^(x - m) and u =
  // sum 2^(x - m) dP, then the cluster's (m, l, u), lane r reading rank
  // r's through distributed shared memory (all ranks' loads in flight
  // together) and the shares added in rank order; lse and Delta, then P
  // and dS of this share's keys in place of the logits and dP
  auto softmax = [&]() {
    for (int h = warp; h < hg; h += kWarps) {
      float m = -CUDART_INF_F;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, X[h * kpb + j]);
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float ref = m == -CUDART_INF_F ? 0.f : m;
      float l = 0.f, u = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = ex2_approx(X[h * kpb + j] - ref);
        l += e;
        u = fmaf(e, DP[h * kpb + j], u);
      }
      for (int off = 16; off > 0; off >>= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, off);
        u += __shfl_xor_sync(0xffffffffu, u, off);
      }
      if (lane == 0) {
        mstat[h] = m;
        lstat[h] = l;
        ustat[h] = u;
      }
    }
    cluster_or_block_sync(splits);
    for (int h = warp; h < hg; h += kWarps) {
      float mr = -CUDART_INF_F, lr = 0.f, ur = 0.f;
      if (lane < splits) {
        if (splits > 1) {
          mr = ld_cluster_f32(map_to_rank(smem_u32(&mstat[h]), lane));
          lr = ld_cluster_f32(map_to_rank(smem_u32(&lstat[h]), lane));
          ur = ld_cluster_f32(map_to_rank(smem_u32(&ustat[h]), lane));
        } else {
          mr = mstat[h];
          lr = lstat[h];
          ur = ustat[h];
        }
      }
      float m = mr;
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float ref = m == -CUDART_INF_F ? 0.f : m;
      const float w = mr == -CUDART_INF_F ? 0.f : ex2_approx(mr - ref);
      lr *= w;
      ur *= w;
      float l = 0.f, u = 0.f;
      for (int r = 0; r < splits; ++r) {   // in rank order
        l += __shfl_sync(0xffffffffu, lr, r);
        u += __shfl_sync(0xffffffffu, ur, r);
      }
      // every key at -inf: P = 0, every gradient 0
      const float lse = m == -CUDART_INF_F ? CUDART_INF_F : m + log2f(l);
      const float delta = m == -CUDART_INF_F ? 0.f : u / l;
      for (int j = lane; j < n; j += 32) {
        const float p = ex2_approx(X[h * kpb + j] - lse);
        DP[h * kpb + j] = p * (DP[h * kpb + j] - delta);   // dS
        X[h * kpb + j] = round_p(p, T());
      }
    }
    __syncthreads();
  };

  // dk and dv rows of this share's keys: vectors of kVec along the segment
  auto rows_out = [&]() {
    T* dkb = a.dk + b * s[15] + h0 * s[16];
    T* dvb = a.dv + b * s[18] + h0 * s[19];
    for (int c = tid; c < n * per_row; c += kThreads) {
      const int jj = c / per_row, e0 = (c - jj * per_row) * kVec;
      float dk[kVec], dv[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int e = e0 + i, h = e / D;
        dv[i] = X[h * kpb + jj] * dos[e];
        dk[i] = DP[h * kpb + jj] * qs[e] * a.scale;
      }
      const int h = e0 / D, off = e0 - h * D;
      store_vec<T, VB>(dkb + h * s[16] + (kb + jj) * s[17] + off, dk);
      store_vec<T, VB>(dvb + h * s[19] + (kb + jj) * s[20] + off, dv);
    }
  };

  // dq's share: output element oe = tid % W over the keys jj = g (mod G)
  // of a tile of k, g = tid / W
  const int G = kThreads / W;
  const int oe = tid % W, g = tid / W;
  float acc = 0.f;
  auto dq_share = [&](const T* kt, int j0, int nk) {
    if (g < G) {
      const float* dsr = DP + (oe / D) * kpb + j0 - kb;
#pragma unroll 4
      for (int jj = g; jj < nk; jj += G)
        acc = fmaf(dsr[jj], to_f32(kt[jj * W + oe]), acc);
    }
  };

  for (int i = 0; i < kStages - 1; ++i) {
    issue(i);
    cp_async_commit();
  }
  // q and dO while the first tiles are in flight
  for (int e = tid; e < W; e += kThreads) {
    const int h = h0 + e / D, d = e % D;
    qs[e] = to_f32(a.q[b * s[0] + h * s[1] + d]);
    dos[e] = to_f32(a.dout[b * s[9] + h * s[10] + d]);
  }
  __syncthreads();   // q and dO
  for (int i = 0; i < total; ++i) {
    issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* kt = stg + (i % kStages) * stage_elems;
    const int j0 = kb + (i % nt) * tile, nk = min(tile, ke - j0);
    if (i < nt) {
      dots(kt, kt + tile * a.hg_max * D, j0, nk);
    } else {
      dq_share(kt, j0, nk);
    }
    __syncthreads();   // this stage is free for load i + kStages
    if (i == nt - 1) {
      softmax();
      rows_out();
      if (nt == 1) dq_share(kt, j0, nk);   // k is still in its stage
    }
  }
  red[tid] = acc;
  __syncthreads();
  for (int e = tid; e < W; e += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < G; ++r) sum += red[r * W + e];
    part[e] = sum;
  }
  // the cluster's partials, in rank order: rank r stores its share of W
  cluster_or_block_sync(splits);
  const int eb = split * W / splits, ee = (split + 1) * W / splits;
  for (int e = eb + tid; e < ee; e += kThreads) {
    float share[8];   // every rank's, loaded together, then added in order
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < splits)
        share[r] = splits > 1
                       ? ld_cluster_f32(map_to_rank(smem_u32(&part[e]), r))
                       : part[e];
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < splits) sum += share[r];
    const int h = e / D;
    a.dq[b * s[12] + (h0 + h) * s[13] + (e - h * D)] =
        from_f32<T>(sum * a.scale);
  }
  if (splits > 1) cluster_sync();   // the peers have read this block's part
}

template <typename T, int VB>
cudaError_t launch(const Q1Args<T>& a, int B, cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err =
      allow_dynamic_smem(flash_bwd_q1_kernel<T, VB>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int kpb = (a.Tk + a.splits - 1) / a.splits;
  const int nt = (min(kpb, a.Tk) + a.tile - 1) / a.tile;
  const size_t smem = sizeof(float) * q1b_floats(a.hg_max, a.D, kpb) +
                      sizeof(T) * size_t(nt == 1 ? 1 : kStages) * 2 *
                          a.tile * a.hg_max * a.D;
  if (smem > size_t(kMaxSmem) || a.splits < 1 || a.splits > 8 ||
      (a.splits - 1) * kpb >= a.Tk || a.hg_max * a.D > kThreads)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.H + a.hg_max - 1) / a.hg_max) * a.splits, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_q1_kernel<T, VB>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int launch_vec(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, void* dq, void* dk, void* dv, int B, int H,
               int Tq, int Tk, int D, const int64_t* s, float scale, int hg,
               int tile, int splits, int vec_bytes, void* stream) {
  if (Tq != 1 || D < 1 || D > 128 || hg < 1 || tile < 1)
    return int(cudaErrorInvalidValue);
  Q1Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.dout = static_cast<const T*>(dout);
  a.bias = static_cast<const float*>(bias);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.H = H;
  a.Tk = Tk;
  a.D = D;
  a.hg_max = hg;
  a.tile = tile;
  a.splits = splits;
  for (int i = 0; i < 21; ++i) a.s[i] = s[i];
  a.scale_log2 = scale * kLog2e;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return int(launch<T, 16>(a, B, st));
    case 8: return int(launch<T, 8>(a, B, st));
    case 4: return int(launch<T, 4>(a, B, st));
    default:
      if (vec_bytes == int(sizeof(T)))
        return int(launch<T, int(sizeof(T))>(a, B, st));
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace ns2vc

#define NS2VC_Q1_BWD_ARGS                                                     \
  const void *q, const void *k, const void *v, const void *bias,             \
      const void *dout, void *dq, void *dk, void *dv, void *ws, int B, int H, \
      int Tq, int Tk, int D, int64_t q_sb, int64_t q_sh, int64_t q_st,        \
      int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,   \
      int64_t v_st, int64_t do_sb, int64_t do_sh, int64_t do_st,              \
      int64_t dq_sb, int64_t dq_sh, int64_t dq_st, int64_t dk_sb,             \
      int64_t dk_sh, int64_t dk_st, int64_t dv_sb, int64_t dv_sh,             \
      int64_t dv_st, float scale, int heads_per_block, int tile, int splits,  \
      int vec_bytes, void *stream
#define NS2VC_Q1_BWD_STRIDES                                                  \
  const int64_t s[21] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,  k_st,  v_sb,     \
                         v_sh,  v_st,  do_sb, do_sh, do_st, dq_sb, dq_sh,     \
                         dq_st, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st}

// bf16 q, k, v, dout (the gradient of o) as (B, H, T, D) views by element
// strides (batch, head, seq) with unit stride on D, Tq == 1, D <= 128; bias
// (B, Tk) f32 contiguous or null; dq, dk, dv (B, H, T, D) views by their
// strides, written whole; scale the forward's; ws unused (null). Blocks of
// `heads_per_block` heads (a row segment of at most 256 elements) over key
// tiles of `tile` keys, the keys dealt to `splits` (1..8, none empty)
// blocks of a cluster (`plan_q1_backward`); vec_bytes (16, 8, 4, or the
// element size) divides every segment, head offset, stride and base the
// loads of k, v and the stores of dk, dv use (`q1_vec_bytes`). A shared
// memory need above the block's 227 KB is refused. Returns the CUDA error
// of the launch (0 on success).
extern "C" int ns2vc_flash_attention_bwd_q1(NS2VC_Q1_BWD_ARGS) {
  NS2VC_Q1_BWD_STRIDES;
  (void)ws;
  return ns2vc::launch_vec<ns2vc::bf16>(q, k, v, bias, dout, dq, dk, dv, B,
                                        H, Tq, Tk, D, s, scale,
                                        heads_per_block, tile, splits,
                                        vec_bytes, stream);
}

// The same kernel over f32 tensors (the f32 route's pools): P is not
// rounded before dv.
extern "C" int ns2vc_flash_attention_bwd_q1_f32(NS2VC_Q1_BWD_ARGS) {
  NS2VC_Q1_BWD_STRIDES;
  (void)ws;
  return ns2vc::launch_vec<float>(q, k, v, bias, dout, dq, dk, dv, B, H, Tq,
                                  Tk, D, s, scale, heads_per_block, tile,
                                  splits, vec_bytes, stream);
}
