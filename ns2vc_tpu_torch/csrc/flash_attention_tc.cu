// Flash attention forward on Hopper's tensor cores (sm_90a), bf16 in and out:
//     o = softmax(q.k^T * scale + key_bias) . v
//
// Replaces: ns2vc_tpu/ops/pallas_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`) for bf16 inputs whose rows are not whole
// aligned 16-byte chunks (the wrapper's sub-route "tc_narrow": the pooling
// attentions at D = 4 and 100, odd D or strides), with element loads;
// every other bf16 call goes to flash_attention_wgmma.cu, which took its
// place (TMA, wgmma, the softmax overlapped with the products),
// and f32 calls to flash_attention.cu (three TF32 passes: one would break
// the f32 bound). Its 16-byte cp.async path (vec != 0) is the baseline
// that scripts/torch_k1_bf16_compare.py and chip_smoke.py time the wgmma
// kernel against.
//
// What bounds it on the H100: at the UNet's shapes (B*H = 128, T <= 448,
// head dim 16..64) one call moves a few MB and does a few GFLOP, so the
// bound is device memory (q, k, v read once, o written once); a kernel of
// scalar FMAs fed from shared memory reached ~2.6 % of it.
// What the design does about it (FlashAttention-2): one block of 4 warps
// per (64-query tile, batch*head); each warp owns 16 query rows whose Q
// fragments stay in registers for the whole key loop. Key/value tiles of 64
// rows are double-buffered in shared memory with 16-byte cp.async (the next
// tile's copy overlaps this tile's math), with the per-key bias beside them.
// S = Q.K^T and O += P.V run as mma.sync m16n8k16 (bf16 -> f32) fed by
// ldmatrix (V through ldmatrix.trans); the online softmax stays in
// registers (quad shuffles) in the log2 domain, and P is rounded to bf16 and
// reused in registers as the A operand of P.V, as the plain version casts
// the probabilities to v's dtype. The running max starts at -inf and a row
// whose max is still -inf subtracts 0, keys past Tk get -inf and the row sum
// is floored at 1e-30, so a fully masked row stays finite (and, as the plain
// version, uniform over its keys when every bias is equal). Rows are padded
// by 16 bytes in shared memory, so ldmatrix reads are free of bank
// conflicts. The head dim is templated at DP in {16, 32, 48, 64, 112, 128}
// (D = 4 -> 16, 100 -> 112; 128 for the encoder op registry's two-head
// layers). q/k/v are read through (batch, head, seq) strides, so the packed
// (B, T, 3C) projection goes in without a copy; when a row is not made of
// aligned 16-byte chunks (D = 4, 100 or odd, or odd strides) the caller
// passes vec = 0, the tiles are staged with element loads instead of
// cp.async and the output is written element by element.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // queries per block (16 per warp)
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
__host__ __device__ constexpr int row_stride() {  // bf16 elements, +16 bytes
  return DP + 8;
}

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q, two K and two V tiles, then two bias rows
  return sizeof(bf16) * 5 * kBK * row_stride<DP>() + sizeof(float) * 2 * kBK;
}

// rows [row0, row0 + 64) of a (T, D) matrix with row stride st -> a 64 x DP
// shared tile; rows past T and columns past D become zeros
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t st, int row0, int T, int D,
                                          bool vec, int tid) {
  constexpr int S = row_stride<DP>();
  if (vec) {
    constexpr int CH = DP / 8;  // 16-byte chunks per row
    for (int e = tid; e < kBK * CH; e += kThreads) {
      const int r = e / CH, d = (e % CH) * 8, t = row0 + r;
      const bool in = t < T && d < D;
      cp_async_16(smem_u32(dst + r * S + d), in ? src + t * st + d : src,
                  in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, d = e % DP, t = row0 + r;
      dst[r * S + d] = (t < T && d < D) ? src[t * st + d] : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    bf16* __restrict__ o, int H, int Tq, int Tk, int D,
                    int64_t q_sb, int64_t q_sh, int64_t q_st,
                    int64_t k_sb, int64_t k_sh, int64_t k_st,
                    int64_t v_sb, int64_t v_sh, int64_t v_st,
                    int64_t o_sb, int64_t o_sh, int64_t o_st,
                    float scale_log2, int vec) {
  constexpr int S = row_stride<DP>();
  constexpr int KC = DP / 16;  // 16-wide steps over the head dim
  constexpr int DN = DP / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * S;       // [2][kBK][S]
  bf16* Vs = Ks + 2 * kBK * S;   // [2][kBK][S]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kBK * S);  // [2][kBK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  bf16* ob = o + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + int64_t(b) * Tk : nullptr;
  const int n_tiles = (Tk + kBK - 1) / kBK;

  auto load_kv = [&](int j, int buf) {
    load_tile<DP>(Ks + buf * kBK * S, kb, k_st, j * kBK, Tk, D, vec, tid);
    load_tile<DP>(Vs + buf * kBK * S, vb, v_st, j * kBK, Tk, D, vec, tid);
    if (tid < kBK) {  // the key bias in the log2 domain; -inf past Tk
      const int key = j * kBK + tid;
      Bs[buf * kBK + tid] =
          key < Tk ? (biasb ? biasb[key] * kLog2e : 0.f) : -CUDART_INF_F;
    }
  };

  load_tile<DP>(Qs, qb, q_st, q0, Tq, D, vec, tid);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KC][4];
  float acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (log2 domain) and the
  // thread's part of the row sum (summed over the quad at the end)
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3],
                smem_u32(Qs + (warp * 16 + (lane & 15)) * S + kc * 16 +
                         (lane >> 4) * 8));
    }

    // S = Q.K^T: 8 tiles of 8 keys, each 4 f32 per thread
    const bf16* Kb = Ks + buf * kBK * S;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int row = np * 16 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                smem_u32(Kb + row * S + kc * 16 + (((lane >> 3) & 1) << 3)));
        mma_bf16_16816(s[2 * np], qf[kc], b0, b1);
        mma_bf16_16816(s[2 * np + 1], qf[kc], b2, b3);
      }
    }

    // online softmax in registers, log2 domain
    const float* Bb = Bs + buf * kBK;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = nt * 8 + (lane & 3) * 2;
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
    for (int nt = 0; nt < 8; ++nt) {
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

    // O += P.V: P from registers (bf16), V through ldmatrix.trans
    const bf16* Vb = Vs + buf * kBK * S;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int row = kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3,
                      smem_u32(Vb + row * S + dp * 16 + ((lane >> 4) << 3)));
        mma_bf16_16816(acc[2 * dp], pa, b0, b1);
        mma_bf16_16816(acc[2 * dp + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile j + 2
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + warp * 16 + (lane >> 2) + 8 * i;
    if (t >= Tq) continue;
    bf16* orow = ob + t * o_st;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + (lane & 3) * 2;
      const float v0 = acc[dn][2 * i] * inv[i], v1 = acc[dn][2 * i + 1] * inv[i];
      if (vec) {  // D % 8 == 0: d < D => d + 1 < D; o rows 16-byte aligned
        if (d < D) *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16x2(v0, v1);
      } else {
        if (d < D) orow[d] = __float2bfloat16(v0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, int B, int H, int Tq, int Tk,
                   int D, const int64_t* s, float scale, int vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err =
      allow_dynamic_smem(flash_fwd_tc_kernel<DP>, int(smem), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(o), H, Tq, Tk, D,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      scale * kLog2e, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ns2vc

// bf16 q/k/v/o as (B, H, T, D) views given by element strides (batch, head,
// seq) with unit stride on D; bias (B, Tk) f32 contiguous or null. The
// caller guarantees 1 <= D <= 128, Tq >= 1, Tk >= 1, B*H <= 65535, and,
// when vec != 0, that q/k/v/o and their strides are 16-byte aligned and D is
// a multiple of 8.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ns2vc_flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int B, int H, int Tq, int Tk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, float scale, int vec,
    void* stream) {
  const int64_t s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                         v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using ns2vc::launch;
  if (D <= 16) return launch<16>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, vec, st);
  if (D <= 32) return launch<32>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, vec, st);
  if (D <= 48) return launch<48>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, vec, st);
  if (D <= 64) return launch<64>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, vec, st);
  if (D <= 112) return launch<112>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, vec, st);
  if (D <= 128) return launch<128>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, vec, st);
  return int(cudaErrorInvalidValue);
}
