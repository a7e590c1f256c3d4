// Single-query attention with an additive key bias, f32 or bf16:
//     o = softmax(q . k^T * scale + key_bias) . v,   Tq = 1
// q (B, H, 1, D), k/v (B, H, Tk, D), any D <= 128, through (batch, head,
// seq) strides, as the other K1 kernels take them.
//
// Replaces: ns2vc_tpu/ops/pallas_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`) for calls of one query: the two attention
// pools (models/encoders.py AttentionPooling: `ref_enc`, 1 head x 1 query
// over 321 keys x D = 100, and the UNet's `add_embedding`, 64 heads x 4).
// The tile kernels give such a call a 64-query tile of which 63 rows are
// padding; the mma.sync kernel (flash_attention_tc.cu), which took them,
// staged those tiles with element loads and lost to SDPA.
//
// What bounds it on the H100: bytes. k and v are read once (~2.06 MB for
// `ref_enc` and ~2.63 MB for `add_embedding` at B = 16: 0.6 and 0.8 us at
// 3.35 TB/s), against 4 H Tk D flops; at these sizes the call is a few
// microseconds of memory latency, so the design keeps loads in flight and
// the arithmetic off the tensor cores.
// What the design does about it: blocks of 256 threads per (batch row,
// group of heads, share of the keys); the wrapper (`plan_q1`) sizes the
// groups and shares so that the grid reaches the card's SMs where the
// heads and keys allow it (a single-head pool at B = 16 is otherwise 16
// blocks each walking 321 keys, which measured slower than SDPA), each
// block's row segment (its heads' H_g x D values of a key) is at most 512
// bytes, and its logits fit in shared memory. The shares of one (batch
// row, group) form a thread block cluster of up to 8. The pools' k and v
// are head views of one (B, Tk, C) projection, so a group's heads lie in
// one contiguous segment of each key row: it is read with the widest
// vector the alignment of the tensors allows (16, 8 or 4 bytes by
// cp.async, whatever D is; bf16 rows with no 4-byte alignment by element
// loads), a tile of keys per stage, with 3 stages in flight over the key
// tiles of k and then of v. Logits are f32 dot products on the CUDA cores,
// a pair (head, key) per power-of-two group of lanes reduced by warp
// shuffles; they stay in shared memory, so the softmax is exact, not
// online: per head a warp takes its share's max, the cluster's max (from
// -inf) is read through distributed shared memory, then its share's sum of
// exponentials, and the cluster's sum in rank order (floored at 1e-30, so a
// fully masked row stays finite); the probabilities are rounded to v's
// dtype before the PV sum, as the plain version rounds them
// (`flash_attention_plain`). The PV sum accumulates in f32 per output
// element over a share of the block's keys; the shares, and then the
// cluster's blocks, are added in a fixed order (deterministic).
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
constexpr int kStages = 3;
constexpr int kMaxSmem = 232448;

template <int VB>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(VB));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// a probability as the PV sum takes it: rounded to v's dtype
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, bf16) {
  return __bfloat162float(__float2bfloat16(p));
}

// The shared memory (floats) of a block of `hg` heads of D over `kpb` keys
// before its stages: q, the logits, the PV shares, the cluster's max and
// sum per head and the block's PV partial, 16-byte aligned. `q1_smem` in
// ops/flash_attention.py mirrors it.
__host__ __device__ inline int q1_floats(int hg, int D, int kpb) {
  return ((2 * hg * D + hg * kpb + kThreads + 2 * hg) + 3) & ~3;
}

// every thread of the cluster (of the block when it is one)
__device__ __forceinline__ void cluster_or_block_sync(int splits) {
  if (splits > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
flash_fwd_q1_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    T* __restrict__ o, int H, int Tk, int D, int64_t q_sb,
                    int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
                    int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb,
                    int64_t o_sh, float scale, int hg_max, int tile,
                    int splits) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVec = VB / int(sizeof(T));   // elements per load
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = int(blockIdx.x) % splits;   // its rank in the cluster
  const int b = blockIdx.y, h0 = (blockIdx.x / splits) * hg_max;
  const int hg = min(hg_max, H - h0);
  const int W = hg * D;                  // this block's row segment
  const int kpb = (Tk + splits - 1) / splits;
  const int kb = split * kpb, ke = min(Tk, kb + kpb);   // its keys
  const int stage_elems = tile * hg_max * D;
  float* qs = smem;                      // hg * D
  float* S = qs + hg_max * D;            // hg * kpb: logits, then P
  float* red = S + hg_max * kpb;         // kThreads PV shares
  float* mstat = red + kThreads;         // hg: the share's max per head
  float* lstat = mstat + hg_max;         // hg: the share's sum per head
  float* part = lstat + hg_max;          // W: the block's PV partial
  T* stg = reinterpret_cast<T*>(smem + q1_floats(hg_max, D, kpb));

  for (int e = tid; e < W; e += kThreads)
    qs[e] = to_f32(q[b * q_sb + (h0 + e / D) * q_sh + e % D]);

  // load i: key tile i of k (i < nt), else tile i - nt of v, of this
  // block's keys, into stage i % kStages; vectors of kVec elements (whole
  // ones: the wrapper checked that every segment, offset and stride is a
  // multiple)
  const int nt = (ke - kb + tile - 1) / tile, total = 2 * nt;
  const int per_row = W / kVec;
  auto issue = [&](int i) {
    if (i >= total) return;
    const bool is_k = i < nt;
    const T* src = is_k ? k : v;
    const int64_t sb = is_k ? k_sb : v_sb, sh = is_k ? k_sh : v_sh;
    const int64_t st = is_k ? k_st : v_st;
    const int j0 = kb + (i % nt) * tile, nk = min(tile, ke - j0);
    T* dst = stg + (i % kStages) * stage_elems;
    for (int c = tid; c < nk * per_row; c += kThreads) {
      const int jj = c / per_row, e = (c - jj * per_row) * kVec;
      const int h = e / D;
      const T* p = src + b * sb + (h0 + h) * sh + (j0 + jj) * st + (e - h * D);
      T* d = dst + jj * W + e;
      if constexpr (VB >= 4) {
        cp_async_ca<VB>(smem_u32(d), p);
      } else {
        *d = *p;
      }
    }
  };

  // threads per (head, key) pair of the logits: the most (a power of two
  // up to a warp) that the tile's pairs leave room for
  int tpp = 1;
  while (tpp < 32 && 2 * tpp * hg * min(tile, ke - kb) <= kThreads) tpp *= 2;
  auto logits = [&](const T* kt, int j0, int nk) {
    const int npair = hg * nk, per = kThreads / tpp, sub = tid % tpp;
    for (int p0 = 0; p0 < npair; p0 += per) {   // the same trip count for all
      const int p = p0 + tid / tpp, jj = p / hg, h = p - jj * hg;
      float s = 0.f;
      if (p < npair) {
        const T* kr = kt + jj * W + h * D;
        const float* qh = qs + h * D;
#pragma unroll 4
        for (int d = sub; d < D; d += tpp) s = fmaf(qh[d], to_f32(kr[d]), s);
      }
      for (int off = tpp / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (p < npair && sub == 0) {
        const float kbias =
            bias != nullptr ? bias[int64_t(b) * Tk + j0 + jj] : 0.f;
        S[h * kpb + j0 - kb + jj] = s * scale + kbias;
      }
    }
  };

  // per head (a warp each): P = exp(s - max) / max(sum, 1e-30), rounded,
  // the max and the sum over the cluster's keys
  auto softmax = [&]() {
    const int n = ke - kb;
    for (int h = warp; h < hg; h += kThreads / 32) {
      float m = -CUDART_INF_F;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, S[h * kpb + j]);
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) mstat[h] = m;
    }
    cluster_or_block_sync(splits);
    for (int h = warp; h < hg; h += kThreads / 32) {
      float m = mstat[h];
      for (int r = 0; r < splits; ++r)
        if (r != split)
          m = fmaxf(m, ld_cluster_f32(map_to_rank(smem_u32(&mstat[h]), r)));
      if (m == -CUDART_INF_F) m = 0.f;   // every key at -inf: P = 0, o = 0
      float l = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(S[h * kpb + j] - m);
        S[h * kpb + j] = e;
        l += e;
      }
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) lstat[h] = l;
    }
    cluster_or_block_sync(splits);
    for (int h = warp; h < hg; h += kThreads / 32) {
      float l = 0.f;
      for (int r = 0; r < splits; ++r)   // in rank order
        l += splits > 1 ? ld_cluster_f32(map_to_rank(smem_u32(&lstat[h]), r))
                        : lstat[h];
      l = fmaxf(l, 1e-30f);
      for (int j = lane; j < n; j += 32)
        S[h * kpb + j] = round_p(S[h * kpb + j] / l, T());
    }
  };

  // PV: output element e = tid % W over the keys jj = g (mod G) of a tile,
  // g = tid / W
  const int G = kThreads / W;
  const int oe = tid % W, g = tid / W;
  float acc = 0.f;
  auto pv = [&](const T* vt, int j0, int nk) {
    if (g < G) {
      const float* pr = S + (oe / D) * kpb + j0 - kb;
#pragma unroll 4
      for (int jj = g; jj < nk; jj += G)
        acc = fmaf(pr[jj], to_f32(vt[jj * W + oe]), acc);
    }
  };

  for (int i = 0; i < kStages - 1; ++i) {
    issue(i);
    cp_async_commit();
  }
  __syncthreads();   // q
  for (int i = 0; i < total; ++i) {
    issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* t = stg + (i % kStages) * stage_elems;
    const int j0 = kb + (i % nt) * tile, nk = min(tile, ke - j0);
    if (i < nt) {
      logits(t, j0, nk);
    } else {
      pv(t, j0, nk);
    }
    __syncthreads();   // this stage is free for load i + kStages
    if (i == nt - 1) {
      softmax();
      __syncthreads();
    }
  }
  red[tid] = acc;
  __syncthreads();
  for (int e = tid; e < W; e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < G; ++r) s += red[r * W + e];
    part[e] = s;
  }
  // the cluster's partials, in rank order: rank r stores its share of W
  cluster_or_block_sync(splits);
  const int eb = split * W / splits, ee = (split + 1) * W / splits;
  for (int e = eb + tid; e < ee; e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < splits; ++r)
      s += splits > 1 ? ld_cluster_f32(map_to_rank(smem_u32(&part[e]), r))
                      : part[e];
    const int h = e / D;
    store(o + b * o_sb + (h0 + h) * o_sh + (e - h * D), s);
  }
  if (splits > 1) cluster_sync();   // the peers have read this block's part
}

template <typename T, int VB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, int B, int H, int Tk, int D,
                   const int64_t* s, float scale, int hg, int tile,
                   int splits, cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err =
      allow_dynamic_smem(flash_fwd_q1_kernel<T, VB>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int kpb = (Tk + splits - 1) / splits;
  const size_t smem = sizeof(float) * q1_floats(hg, D, kpb) +
                      sizeof(T) * size_t(kStages) * tile * hg * D;
  if (smem > size_t(kMaxSmem) || splits < 1 || splits > 8 ||
      (splits - 1) * kpb >= Tk)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((H + hg - 1) / hg) * splits, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, flash_fwd_q1_kernel<T, VB>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(o), H, Tk, D, s[0], s[1], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], scale, hg, tile, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(int vec_bytes, const void* q, const void* k,
                       const void* v, const float* bias, void* o, int B, int H,
                       int Tk, int D, const int64_t* s, float scale, int hg,
                       int tile, int splits, cudaStream_t st) {
  switch (vec_bytes) {
    case 16:
      return launch<T, 16>(q, k, v, bias, o, B, H, Tk, D, s, scale, hg, tile,
                           splits, st);
    case 8:
      return launch<T, 8>(q, k, v, bias, o, B, H, Tk, D, s, scale, hg, tile,
                          splits, st);
    case 4:
      return launch<T, 4>(q, k, v, bias, o, B, H, Tk, D, s, scale, hg, tile,
                          splits, st);
    default:
      if (vec_bytes == int(sizeof(T)))
        return launch<T, int(sizeof(T))>(q, k, v, bias, o, B, H, Tk, D, s,
                                         scale, hg, tile, splits, st);
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ns2vc

// q (B, H, 1, D), k/v (B, H, Tk, D), o (B, H, 1, D) through the strides
// given per tensor as (batch, head, seq) (the seq strides of q and o are
// unused); bias (B, Tk) f32 contiguous or null; D <= 128; bf16 != 0: bf16
// tensors, else f32. Blocks of `heads_per_block` heads (its row segment at
// most 512 bytes) over key tiles of `tile` keys, the keys dealt to
// `splits` (1..8, none empty) blocks of a cluster; vec_bytes (16, 8, 4, or
// the element size) divides every segment, head offset, stride and base
// the loads use. The caller guarantees Tq == 1 and B <= 65535; a shared
// memory need (`plan_q1`) above the block's 227 KB is refused. Returns
// the CUDA error of the launch.
extern "C" int ns2vc_flash_attention_q1_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int B, int H, int Tq, int Tk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, float scale,
    int heads_per_block, int tile, int splits, int vec_bytes, int bf16,
    void* stream) {
  using namespace ns2vc;
  if (Tq != 1) return int(cudaErrorInvalidValue);
  const int64_t s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                         v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch_vec<__nv_bfloat16>(vec_bytes, q, k, v, bf, o, B, H,
                                              Tk, D, s, scale,
                                              heads_per_block, tile, splits,
                                              st)
                  : launch_vec<float>(vec_bytes, q, k, v, bf, o, B, H, Tk, D,
                                      s, scale, heads_per_block, tile, splits,
                                      st));
}
