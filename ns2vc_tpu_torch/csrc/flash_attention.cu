// Flash attention forward on Hopper's tensor cores (sm_90a), f32 in and out,
// at f32 accuracy through 3xTF32:
//     o = softmax(q.k^T * scale + key_bias) . v
//
// Replaces: ns2vc_tpu/ops/pallas_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`) for f32 inputs; bf16 calls go to
// flash_attention_tc.cu. Same function: an online softmax over key tiles,
// running max / sum / accumulator in f32, the row sum floored at 1e-30 so a
// row whose keys are all masked stays finite.
//
// What bounds it on the H100: f32 accuracy (the JAX suite's 2e-5) rules out
// a single TF32 pass (~3e-4 of the output at these sums); on the f32 CUDA
// cores (67 TFLOP/s) the old kernel of this file ran at ~12 % of even that
// rate, limited by shared-memory loads feeding scalar FMAs and a score tile
// round-tripped through shared memory. With three TF32 passes the least time
// is 3 x FLOPs over 494.7 TFLOP/s, or q, k, v and o over device memory: at
// ContentVec's (1, 12, 400, 64) ~3 us. At these small grids (ContentVec's
// B*H = 12, the op registry's 8) the kernel is bound by the latency of each
// warp's chain of shared-memory reads and tensor-core products, so the
// design keeps that chain short.
// What the design does about it (FlashAttention-2 on mma.sync m16n8k8
// TF32): each f32 operand is split into a TF32 "big" half (cvt.rna) and the
// TF32 rounding of the exact remainder; each product is big.big + big.small
// + small.big in f32 (mma.cuh `mma_3xtf32`), within ~2^-21 of the f32
// product. One block of 4 warps takes 64 queries of one (batch, head); each
// warp owns 16 query rows. The key loop walks tiles of K, V (f32) and the
// key bias, copied with 16-byte cp.async while the previous tile computes.
// Each warp's tiles run one after another, so at small grids (ContentVec's
// B*H = 12, the op registry's 8) the time is the latency of that chain: the
// wrapper's planner then splits the key tiles over blockIdx.z (as many
// splits as fit the SMs' resident blocks), each split writes its
// unnormalised output, row max and row sum to a workspace, and a second
// kernel merges them (the online softmax's rescaling, across splits).
// Each tile is split once per block, not once per warp: K into its big half
// (in place) and a small plane, V into big and small planes stored
// transposed (head dim by key), so every B fragment of both products is one
// ldmatrix per plane (8 rows of four 32-bit values give lane (g, t) its
// fragment value). S = Q.K^T stays in registers; the online softmax runs
// there (quad shuffles, log2 domain), and P is reused in registers as the A
// operand of P.V: the 8 keys of an m16n8k8 step are taken in the order
// 0, 2, 4, 6 | 1, 3, 5, 7, so the S accumulator's (g, 2t), (g, 2t + 1)
// pair is exactly the A fragment's (g, t), (g, t + 4) and no shuffle is
// needed; V's transposed planes store each 8 keys in that order. Rows are
// padded by 16 bytes, which keeps ldmatrix free of bank conflicts. Keys
// past Tk get -inf; the running max starts at -inf and a row whose max is
// still -inf subtracts 0. Q is split once. Up to DP = 64 its two halves
// stay in registers for the whole key loop (read from device memory
// directly, once per block); at DP = 128 they would not fit beside the
// 64-register output accumulator, so Q's halves are stored as two planes in
// shared memory and read per k-step, and tiles hold 32 keys, so that the Q
// planes, K and V's planes and the raw tiles (172 KB) fit one block per
// SM. Up to DP = 64 tiles hold 64 keys and a block takes 105 KB:
// two blocks per SM. The head dim is templated at DP in {16, 32, 48, 64,
// 128}; padded columns are zeros. q/k/v/o are read and written through
// (batch, head, seq) strides with a unit stride on the head dim, so the
// packed (B, T, 3C) projection goes in without a copy; when a row is not
// made of aligned 16-byte chunks (D % 4, odd strides) the caller passes
// vec = 0 and tiles are staged with element loads. Later work: wgmma, TMA.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;  // warps per block, 16 query rows each
constexpr int kBQ = 16 * kWarps;

template <int DP>
struct Tile {
  static constexpr bool kQReg = DP <= 64;   // Q's halves in registers
  static constexpr int kBK = kQReg ? 64 : 32;  // keys per tile
  static constexpr int S = DP + 4;          // K / Q row stride (floats)
  static constexpr int VS = kBK + 4;        // transposed V row stride
};

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  using T = Tile<DP>;
  // Q's two planes (DP = 128), two raw K tiles (the big half in place),
  // K's small plane, the raw V tile, V's two transposed planes, two bias
  // rows
  return sizeof(float) * ((T::kQReg ? 0 : 2 * kBQ * T::S) +
                          4 * T::kBK * T::S + 2 * DP * T::VS + 2 * T::kBK);
}

// rows [row0, row0 + ROWS) of a (T, D) matrix with row stride st -> a
// ROWS x DP shared tile (row stride DP + 4); rows past T and columns past D
// become zeros
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t st, int row0, int T, int D,
                                          bool vec, int tid) {
  constexpr int S = Tile<DP>::S;
  if (vec) {
    constexpr int CH = DP / 4;  // 16-byte chunks per row
    for (int e = tid; e < ROWS * CH; e += NT) {
      const int r = e / CH, d = (e % CH) * 4, t = row0 + r;
      const bool in = t < T && d < D;
      cp_async_16(smem_u32(dst + r * S + d), in ? src + t * st + d : src,
                  in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * DP; e += NT) {
      const int r = e / DP, d = e % DP, t = row0 + r;
      dst[r * S + d] = (t < T && d < D) ? src[t * st + d] : 0.f;
    }
  }
}

// key r's column in V's transposed planes: each 8 keys in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (the P.V product's k order)
__device__ __forceinline__ int key_slot(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias, float* __restrict__ o,
                       int H, int Tq, int Tk, int D,
                       int64_t q_sb, int64_t q_sh, int64_t q_st,
                       int64_t k_sb, int64_t k_sh, int64_t k_st,
                       int64_t v_sb, int64_t v_sh, int64_t v_st,
                       int64_t o_sb, int64_t o_sh, int64_t o_st,
                       float scale_log2, int vec, int tiles_per_split,
                       float* __restrict__ ws_o, float* __restrict__ ws_ml) {
  using T = Tile<DP>;
  constexpr int NT = kWarps * 32, BQ = kBQ, BK = T::kBK;
  constexpr int S = T::S, VS = T::VS;
  constexpr int KS = DP / 8;   // 8-wide k-steps over the head dim
  constexpr int DN = DP / 8;   // 8-wide output column tiles
  constexpr int NTK = BK / 8;  // 8-key score tiles
  constexpr bool kQReg = T::kQReg;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                              // [2][BQ][S] (DP = 128)
  float* Kr = Qs + (kQReg ? 0 : 2 * BQ * S);     // [2][BK][S] raw / big
  float* Ksm = Kr + 2 * BK * S;                  // [BK][S] small
  float* Vr = Ksm + BK * S;                      // [BK][S] raw
  float* Vtb = Vr + BK * S;                      // [DP][VS] big, transposed
  float* Vts = Vtb + DP * VS;                    // [DP][VS] small
  float* Bs = Vts + DP * VS;                     // [2][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  float* ob = o + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + int64_t(b) * Tk : nullptr;
  // this block's key tiles: all of them, or its split's
  const int j_begin = blockIdx.z * tiles_per_split;
  const int j_end = min((Tk + BK - 1) / BK, j_begin + tiles_per_split);
  const int r0 = warp * 16 + g;  // this thread's first row in the block

  auto load_kv = [&](int j) {
    load_tile<DP, BK, NT>(Kr + (j & 1) * BK * S, kb, k_st, j * BK, Tk, D, vec,
                          tid);
    load_tile<DP, BK, NT>(Vr, vb, v_st, j * BK, Tk, D, vec, tid);
    for (int c = tid; c < BK; c += NT) {  // the key bias, log2 domain
      const int key = j * BK + c;
      Bs[(j & 1) * BK + c] =
          key < Tk ? (biasb ? biasb[key] * kLog2e : 0.f) : -CUDART_INF_F;
    }
    cp_async_commit();
  };

  // Q's big and small halves of this warp's rows: registers (DP <= 64,
  // read from device memory once) or two shared planes (DP = 128)
  uint32_t qbig[kQReg ? KS : 1][4], qsmall[kQReg ? KS : 1][4];
  if constexpr (kQReg) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = q0 + r0 + (e & 1) * 8, d = ks * 8 + t4 + (e >> 1) * 4;
        split_tf32(t < Tq && d < D ? qb[t * q_st + d] : 0.f, qbig[ks][e],
                   qsmall[ks][e]);
      }
    }
  } else {
    load_tile<DP, BQ, NT>(Qs, qb, q_st, q0, Tq, D, vec, tid);
  }
  load_kv(j_begin);

  float acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (log2 domain) and the
  // thread's part of the row sum (summed over the quad at the end)
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};

  for (int j = j_begin; j < j_end; ++j) {
    const int buf = j & 1;
    float* Kb = Kr + buf * BK * S;
    cp_async_wait<0>();
    __syncthreads();  // tile j (and at j = 0 the Q tile) is in
    // split K in place (big) and into the small plane, V into its
    // transposed planes (keys fastest across a warp: conflict-free stores)
    for (int e = tid; e < BK * (DP / 4); e += NT) {
      const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
      float4* kp = reinterpret_cast<float4*>(Kb + r * S + c);
      const float4 kv = *kp;
      uint32_t hb[4], hs[4];
      split_tf32(kv.x, hb[0], hs[0]);
      split_tf32(kv.y, hb[1], hs[1]);
      split_tf32(kv.z, hb[2], hs[2]);
      split_tf32(kv.w, hb[3], hs[3]);
      *kp = make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]),
                        __uint_as_float(hb[2]), __uint_as_float(hb[3]));
      *reinterpret_cast<float4*>(Ksm + r * S + c) =
          make_float4(__uint_as_float(hs[0]), __uint_as_float(hs[1]),
                      __uint_as_float(hs[2]), __uint_as_float(hs[3]));
    }
    for (int e = tid; e < BK * (DP / 4); e += NT) {
      const int r = e % BK, c = (e / BK) * 4, slot = key_slot(r);
      const float4 vv = *reinterpret_cast<const float4*>(Vr + r * S + c);
      const float vals[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t hb, hs;
        split_tf32(vals[i], hb, hs);
        Vtb[(c + i) * VS + slot] = __uint_as_float(hb);
        Vts[(c + i) * VS + slot] = __uint_as_float(hs);
      }
    }
    if constexpr (!kQReg) {
      if (j == j_begin) {  // Q in place: the big plane, then the small plane
        for (int e = tid; e < BQ * DP; e += NT) {
          const int idx = (e / DP) * S + e % DP;
          uint32_t hb, hs;
          split_tf32(Qs[idx], hb, hs);
          Qs[idx] = __uint_as_float(hb);
          Qs[BQ * S + idx] = __uint_as_float(hs);
        }
      }
    }
    __syncthreads();  // the planes are in; the raw V tile is free
    if (j + 1 < j_end) load_kv(j + 1);  // overlaps this tile's math

    // S = Q.K^T: NTK tiles of 8 keys, each 4 f32 per thread
    float s[NTK][4];
#pragma unroll
    for (int i = 0; i < NTK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ab[4], as[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qbig[ks][e];
          as[e] = qsmall[ks][e];
        }
      } else {
        const int off = (warp * 16 + (lane & 15)) * S + ks * 8 +
                        (lane >> 4) * 4;
        ldsm_x4(ab[0], ab[1], ab[2], ab[3], smem_u32(Qs + off));
        ldsm_x4(as[0], as[1], as[2], as[3], smem_u32(Qs + BQ * S + off));
      }
#pragma unroll
      for (int np = 0; np < NTK / 2; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
                        ks * 8 + ((lane >> 3) & 1) * 4;
        uint32_t kb4[4], ks4[4];
        ldsm_x4(kb4[0], kb4[1], kb4[2], kb4[3], smem_u32(Kb + off));
        ldsm_x4(ks4[0], ks4[1], ks4[2], ks4[3], smem_u32(Ksm + off));
        mma_3xtf32(s[2 * np], ab, as, kb4[0], kb4[1], ks4[0], ks4[1]);
        mma_3xtf32(s[2 * np + 1], ab, as, kb4[2], kb4[3], ks4[2], ks4[3]);
      }
    }

    // online softmax in registers, log2 domain
    const float* Bb = Bs + buf * BK;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const int key = nt * 8 + t4 * 2;
      const float bias0 = Bb[key], bias1 = Bb[key + 1];
      s[nt][0] = fmaf(s[nt][0], scale_log2, bias0);
      s[nt][1] = fmaf(s[nt][1], scale_log2, bias1);
      s[nt][2] = fmaf(s[nt][2], scale_log2, bias0);
      s[nt][3] = fmaf(s[nt][3], scale_log2, bias1);
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float ref[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      ref[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i];
      alpha[i] = exp2f(m_r[i] - ref[i]);
      m_r[i] = mx[i];
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - ref[e >> 1]);
        l_r[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P.V, 8 keys per step in the order 0 2 4 6 | 1 3 5 7: the A
    // fragment's (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) are P at
    // keys 2t, 2t, 2t + 1, 2t + 1, which this thread already holds
#pragma unroll
    for (int kk = 0; kk < NTK; ++kk) {
      uint32_t pb[4], ps[4];
      split_tf32(s[kk][0], pb[0], ps[0]);
      split_tf32(s[kk][2], pb[1], ps[1]);
      split_tf32(s[kk][1], pb[2], ps[2]);
      split_tf32(s[kk][3], pb[3], ps[3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        const int off = (dp * 16 + (lane & 7) + ((lane >> 4) << 3)) * VS +
                        kk * 8 + ((lane >> 3) & 1) * 4;
        uint32_t vb4[4], vs4[4];
        ldsm_x4(vb4[0], vb4[1], vb4[2], vb4[3], smem_u32(Vtb + off));
        ldsm_x4(vs4[0], vs4[1], vs4[2], vs4[3], smem_u32(Vts + off));
        mma_3xtf32(acc[2 * dp], pb, ps, vb4[0], vb4[1], vs4[0], vs4[1]);
        mma_3xtf32(acc[2 * dp + 1], pb, ps, vb4[2], vb4[3], vs4[2], vs4[3]);
      }
    }
    __syncthreads();  // this tile's planes are free for the next split
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
  if (gridDim.z > 1) {  // a split: its unnormalised rows, max and sum
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = q0 + r0 + 8 * i;
      if (t >= Tq) continue;
      const int64_t row = (int64_t(blockIdx.z) * gridDim.y + bh) * Tq + t;
      float* wrow = ws_o + row * D;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int d = dn * 8 + t4 * 2;
        if (d < D) wrow[d] = acc[dn][2 * i];
        if (d + 1 < D) wrow[d + 1] = acc[dn][2 * i + 1];
      }
      if (t4 == 0) {
        ws_ml[2 * row] = m_r[i];
        ws_ml[2 * row + 1] = l_r[i];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    if (t >= Tq) continue;
    float* orow = ob + t * o_st;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + t4 * 2;
      const float v0 = acc[dn][2 * i] * inv[i], v1 = acc[dn][2 * i + 1] * inv[i];
      if (vec) {  // D % 4 == 0: d < D => d + 1 < D; o rows 16-byte aligned
        if (d < D) *reinterpret_cast<float2*>(orow + d) = make_float2(v0, v1);
      } else {
        if (d < D) orow[d] = v0;
        if (d + 1 < D) orow[d + 1] = v1;
      }
    }
  }
}

// o = the splits' rows merged: with M the largest split max, each split's
// rows and sum scale by 2^(m - M) (a split whose max is -inf adds nothing)
__global__ void split_kv_merge_kernel(const float* __restrict__ ws_o,
                                      const float* __restrict__ ws_ml,
                                      float* __restrict__ o, int H, int Tq,
                                      int D, int splits, int64_t rows,
                                      int64_t o_sb, int64_t o_sh,
                                      int64_t o_st) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       i < rows * D; i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t row = i / D;
    const int d = int(i % D);
    float mx = -CUDART_INF_F;
    for (int z = 0; z < splits; ++z) mx = fmaxf(mx, ws_ml[2 * (z * rows + row)]);
    const float ref = mx == -CUDART_INF_F ? 0.f : mx;
    float l = 0.f, acc = 0.f;
    for (int z = 0; z < splits; ++z) {
      const int64_t zr = z * rows + row;
      const float w = exp2f(ws_ml[2 * zr] - ref);
      l = fmaf(ws_ml[2 * zr + 1], w, l);
      acc = fmaf(ws_o[zr * D + d], w, acc);
    }
    const int t = int(row % Tq), bh = int(row / Tq);
    o[(bh / H) * o_sb + (bh % H) * o_sh + t * o_st + d] =
        acc / fmaxf(l, 1e-30f);
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, int B, int H, int Tq, int Tk,
                   int D, const int64_t* s, float scale, int vec,
                   int tiles_per_split, int splits, float* ws_o,
                   float* ws_ml, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err =
      allow_dynamic_smem(flash_fwd_f32tc_kernel<DP>, int(smem), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H, splits);
  flash_fwd_f32tc_kernel<DP><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, bias, o, H, Tq, Tk, D, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11], scale * kLog2e, vec,
      tiles_per_split, ws_o, ws_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t rows = int64_t(B) * H * Tq;
  const int blocks = int((rows * D + 255) / 256 < 4096 ? (rows * D + 255) / 256
                                                       : 4096);
  split_kv_merge_kernel<<<blocks, 256, 0, stream>>>(
      ws_o, ws_ml, o, H, Tq, D, splits, rows, s[9], s[10], s[11]);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ns2vc

// f32 q/k/v/o as (B, H, T, D) views given by element strides (batch, head,
// seq) with unit stride on D; bias (B, Tk) f32 contiguous or null. Split z
// of `splits` takes the key tiles [z * tiles_per_split, (z + 1) *
// tiles_per_split) (64 keys a tile, 32 at D > 64); with splits > 1, ws_o
// (splits, B*H*Tq, D) and ws_ml (splits, B*H*Tq, 2) are f32 workspaces,
// else null. The caller guarantees 1 <= D <= 128, Tq >= 1, Tk >= 1,
// B*H <= 65535, no empty split, and, when vec != 0, that q/k/v/o and their
// strides are 16-byte aligned and D is a multiple of 4. Returns the CUDA
// error of the launches (0 on success).
extern "C" int ns2vc_flash_attention_f32tc_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int B, int H, int Tq, int Tk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, float scale, int vec,
    int tiles_per_split, int splits, void* ws_o, void* ws_ml, void* stream) {
  const int64_t s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                         v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(o);
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tps = tiles_per_split;
  using ns2vc::launch;
  if (D <= 16) return launch<16>(qf, kf, vf, bf, of, B, H, Tq, Tk, D, s, scale, vec, tps, splits, wo, wml, st);
  if (D <= 32) return launch<32>(qf, kf, vf, bf, of, B, H, Tq, Tk, D, s, scale, vec, tps, splits, wo, wml, st);
  if (D <= 48) return launch<48>(qf, kf, vf, bf, of, B, H, Tq, Tk, D, s, scale, vec, tps, splits, wo, wml, st);
  if (D <= 64) return launch<64>(qf, kf, vf, bf, of, B, H, Tq, Tk, D, s, scale, vec, tps, splits, wo, wml, st);
  if (D <= 128) return launch<128>(qf, kf, vf, bf, of, B, H, Tq, Tk, D, s, scale, vec, tps, splits, wo, wml, st);
  return int(cudaErrorInvalidValue);
}
