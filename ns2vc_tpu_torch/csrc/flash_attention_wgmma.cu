// Flash attention forward on Hopper (sm_90a) with TMA and wgmma, bf16 in
// and out:
//     o = softmax(q.k^T * scale + key_bias) . v
//
// Replaces: ns2vc_tpu/ops/pallas_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`) for bf16 inputs whose rows are whole 16-byte
// chunks (D % 8 == 0, D <= 128, aligned strides); the wrapper sends other
// bf16 rows to flash_attention_tc.cu (sub-route "tc_narrow") and f32 calls
// to flash_attention.cu.
//
// What bounds it on the H100: at the UNet's shapes (B*H = 128, head dims
// 16..64, 56..448 queries over 56..448 keys) a call moves a few MB, so the
// bytes bound is a few microseconds, but every score costs one exponential
// and the SM's special-function units give 16 per clock: at head dims of
// 16..64 the tensor-core work per score (4 D FLOPs) is less than that
// exponential's share of the SM, so the exponentials, not memory or the
// tensor cores, are the floor. A kernel is near it only if the MUFU never
// waits on a product, a copy or a barrier.
// What the design does about it (FlashAttention-3's shape): one block per
// (64 query rows, batch*head), warp specialised:
//   - a producer warp: one thread issues every TMA copy, the Q tile once,
//     then the K and V tiles of BN keys (64; 128 on grids of one wave or
//     less, `plan_wgmma_attention`) into a ring of 2-3 stages (full / empty
//     mbarriers); q, k and v are 4-D tensor maps over (D, H, T, B) of their
//     strided views, so the packed (B, T, 3C) self-attention projection goes
//     in without a copy; rows past T and columns past D arrive as zeros.
//     The warp's 32 lanes write each tile's key bias, in the log2 domain,
//     beside it, -inf past Tk (the zero-filled keys are masked by index);
//     without a bias (the UNet's self-attention) there is none to write,
//     the row max is taken over the raw scores and each probability costs
//     one FMA and one MUFU.EX2, keys past Tk masked in the last tile;
//   - one consumer warpgroup of 64 query rows: S = Q.K^T on wgmma
//     m64nBNk16 with both operands read from swizzled shared memory (K is
//     K-major), the online softmax in registers in the log2 domain with one
//     MUFU.EX2 per probability (ex2.approx.ftz), and O += P.V on wgmma
//     m64nDPk16 with P rounded to bf16 in registers (the mma.sync A
//     fragment, as the plain version casts the probabilities to v's dtype)
//     and V as wgmma's transposed (MN-major) B operand.
// Overlap: tile j's Q.K^T is issued before tile j-1's P.V, and tile j's
// softmax runs while that P.V is in flight; the output is rescaled while
// Q.K^T runs. Blocks are small (160 threads, 82-154 registers at 64-key
// tiles), so two to four share an SM and one's exponentials run beside
// another's products; blocks of two consumer warpgroups (128 query rows
// sharing the K/V tiles) were slower at every UNet geometry on the H100,
// and the mma.sync kernel of flash_attention_tc.cu at every grid timed,
// the B=1 ones included (PERF.md).
// The tiles are swizzled by the row width: 32, 64 or 128 bytes for head
// dims padded to DP = 16, 32 or 64; DP = 128 is two 128-byte panels. A
// head dim between (24, 40, 48, 56, ...) takes the next DP: its tensor map's
// box is wider than the head and TMA fills the columns past D with zeros,
// which add nothing to Q.K^T (whose K steps past D are skipped) and give
// zero output columns, not stored. The running max starts at -inf and a
// row whose max is still -inf subtracts 0, and the row sum is floored at
// 1e-30, so a fully masked row stays finite.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;     // query rows per consumer warpgroup
constexpr int kGroup = 128;   // threads of a warpgroup

template <int DP, int BN>
struct Cfg {
  static constexpr int W = DP < 64 ? 2 * DP : 128;  // swizzle = panel row bytes
  static constexpr int PC = W / 2;                  // head columns per panel
  static constexpr int NP = DP / PC;                // panels
  static constexpr int QPanel = kRows * W;
  static constexpr int QBytes = NP * QPanel;
  static constexpr int KVPanel = BN * W;
  static constexpr int TileBytes = NP * KVPanel;    // one K or V tile
  static constexpr int StageBytes = 2 * TileBytes;
  static constexpr int Stages = StageBytes <= 32768 ? 3 : 2;
  static constexpr int Threads = kGroup + 32;       // + the producer warp
  static constexpr int SmemBytes =
      1024 + QBytes + Stages * StageBytes + Stages * BN * 4;
  static_assert(QPanel % 1024 == 0 && KVPanel % 1024 == 0, "atom alignment");
};

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16_ss(d, a, b, accumulate);
  } else {
    wgmma_m64n64k16_ss(d, a, b, accumulate);
  }
}

template <int DP, int BN, bool kBias>
__global__ void __launch_bounds__(Cfg<DP, BN>::Threads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const float* __restrict__ bias, bf16* __restrict__ o,
                       int H, int Tq, int Tk, int D, int64_t o_sb,
                       int64_t o_sh, int64_t o_st, float scale_log2) {
  using C = Cfg<DP, BN>;
  constexpr int ST = C::Stages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * ST];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  auto k_tile = [&](int s) { return base + C::QBytes + s * C::StageBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + C::TileBytes; };
  float* bias_s = reinterpret_cast<float*>(
      smem_raw + (base - raw) + C::QBytes + ST * C::StageBytes);  // [ST][BN]
  const uint32_t qfull = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + ST + s]); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (Tk + BN - 1) / BN;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 32);               // the producer warp's lanes
      mbar_init(empty(s), kGroup);          // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: the Q tile, then each key tile's K, V (TMA) and key bias
    if (lane == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_arrive_expect_tx(qfull, C::QBytes);
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        tma_load_4d(base + p * C::QPanel, &qmap, qfull, p * C::PC, h, q0, b);
    }
    const float* brow = bias + int64_t(b) * Tk;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(empty(s), ((j / ST) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), C::StageBytes);
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load_4d(k_tile(s) + p * C::KVPanel, &kmap, full(s), p * C::PC,
                      h, j * BN, b);
          tma_load_4d(v_tile(s) + p * C::KVPanel, &vmap, full(s), p * C::PC,
                      h, j * BN, b);
        }
      }
      if (kBias) {
        float* bs = bias_s + s * BN;
#pragma unroll
        for (int i = lane; i < BN; i += 32) {
          const int key = j * BN + i;
          bs[i] = key < Tk ? brow[key] * kLog2e : -CUDART_INF_F;
        }
      }
      mbar_arrive(full(s));
    }
  } else {
    const int g = lane >> 2, qd = lane & 3;
    const int ksteps = (D + 15) / 16;
    float S[BN / 2], O[DP / 2];
    uint32_t P[BN / 16][4];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) O[e] = 0.f;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) S[e] = 0.f;
    // rows g and g + 8 of this warp's 16: running max (log2 domain), the
    // thread's part of the row sum, the last rescale factor
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    float alpha[2] = {0.f, 0.f};

    auto qk = [&](int s) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        if (ks < ksteps) {   // K steps past D would add zeros
          const uint32_t off = (ks * 16 % C::PC) * 2;   // bytes in a row
          const int pnl = ks * 16 / C::PC;
          wgmma_ss<BN>(
              S, wgmma_desc<C::W>(base + pnl * C::QPanel + off, 16, 8 * C::W),
              wgmma_desc<C::W>(k_tile(s) + pnl * C::KVPanel + off, 16,
                               8 * C::W),
              ks > 0);
        }
      }
    };
    auto pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_mn<DP>(O, P[kk],
                        wgmma_desc<C::W>(v_tile(s) + kk * 16 * C::W,
                                         C::KVPanel, 8 * C::W));
    };
    auto fence_s = [&] {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) fence_operand(S[e]);
    };
    auto fence_op = [&] {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) fence_operand(O[e]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_operand(P[kk][e]);
    };
    // S (scores of tile j, in stage s) -> probabilities against the new
    // running max. With a key bias: logits s * scale + bias (-inf past Tk)
    // in the log2 domain, then 2^(x - max). Without one the max is taken
    // over the raw scores (scale > 0) and 2^(s * scale - max) is one FMA
    // and one MUFU.EX2; keys past Tk become -inf in the last tile only.
    auto softmax = [&](int j, int s) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if constexpr (kBias) {
        const float* bs = bias_s + s * BN;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const float2 bb =
              *reinterpret_cast<const float2*>(bs + 8 * c + 2 * qd);
          S[4 * c] = fmaf(S[4 * c], scale_log2, bb.x);
          S[4 * c + 1] = fmaf(S[4 * c + 1], scale_log2, bb.y);
          S[4 * c + 2] = fmaf(S[4 * c + 2], scale_log2, bb.x);
          S[4 * c + 3] = fmaf(S[4 * c + 3], scale_log2, bb.y);
        }
      } else if (j * BN + BN > Tk) {
        const int left = Tk - j * BN;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          if (8 * (e >> 2) + 2 * qd + (e & 1) >= left) S[e] = -CUDART_INF_F;
      }
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        mx[0] = fmaxf(mx[0], fmaxf(S[4 * c], S[4 * c + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(S[4 * c + 2], S[4 * c + 3]));
      }
      float ref[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (!kBias) mx[i] *= scale_log2;
        mx[i] = fmaxf(mx[i], m[i]);
        ref[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i];
        alpha[i] = ex2_approx(m[i] - ref[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int i = (e >> 1) & 1;
        S[e] = ex2_approx(kBias ? S[e] - ref[i]
                                : fmaf(S[e], scale_log2, -ref[i]));
        sum[i] += S[e];
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
    };
    auto to_p = [&] {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        P[kk][0] = pack_bf16x2(S[8 * kk], S[8 * kk + 1]);
        P[kk][1] = pack_bf16x2(S[8 * kk + 2], S[8 * kk + 3]);
        P[kk][2] = pack_bf16x2(S[8 * kk + 4], S[8 * kk + 5]);
        P[kk][3] = pack_bf16x2(S[8 * kk + 6], S[8 * kk + 7]);
      }
    };
    auto rescale = [&] {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        O[4 * j] *= alpha[0];
        O[4 * j + 1] *= alpha[0];
        O[4 * j + 2] *= alpha[1];
        O[4 * j + 3] *= alpha[1];
      }
    };

    mbar_wait(qfull, 0);
    mbar_wait(full(0), 0);
    wgmma_fence();
    qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_s();
    softmax(0, 0);
    to_p();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % ST, sp = (j - 1) % ST;
      mbar_wait(full(s), (j / ST) & 1);
      wgmma_fence();
      qk(s);                 // tile j's scores ...
      wgmma_commit();
      rescale();             // ... while the output takes tile j-1's max
      wgmma_fence();
      pv(sp);                // tile j-1's P.V ...
      wgmma_commit();
      wgmma_wait<1>();
      fence_s();
      softmax(j, s);         // ... while tile j's softmax runs
      wgmma_wait<0>();
      fence_op();
      mbar_arrive(empty(sp));
      to_p();
    }
    rescale();
    wgmma_fence();
    pv((n_tiles - 1) % ST);
    wgmma_commit();
    wgmma_wait<0>();
    fence_op();

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
    bf16* ob = o + int64_t(b) * o_sb + int64_t(h) * o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = q0 + warp * 16 + g + 8 * i;
      if (t >= Tq) continue;
      bf16* orow = ob + int64_t(t) * o_st;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = 8 * j + 2 * qd;   // D % 8 == 0: d < D => d + 1 < D
        if (d < D)
          *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16x2(
              O[4 * j + 2 * i] * inv[i], O[4 * j + 2 * i + 1] * inv[i]);
      }
    }
  }
}

// one operand's tensor map: (D, H, T, B) with element strides (sh, st,
// sb), a box of PC columns x `rows` rows of one head, swizzled as the
// kernel's tiles
int encode_map(CUtensorMap* map, const void* p, int B, int H, int T, int D,
               int64_t sb, int64_t sh, int64_t st, int pc, int rows) {
  const int64_t outer[3][2] = {{sh, H}, {st, T}, {sb, B}};
  uint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of one element is never stepped over: any multiple of
    // 16 bytes will do for its stride
    const uint64_t s = uint64_t(outer[i][0]) * 2;
    strides[i] = outer[i][1] > 1 || (s > 0 && s % 16 == 0) ? s : 16;
  }
  const uint64_t dims[4] = {uint64_t(D), uint64_t(H), uint64_t(T),
                            uint64_t(B)};
  const uint32_t box[4] = {uint32_t(pc), 1, uint32_t(rows), 1};
  const CUtensorMapSwizzle sw = pc == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : pc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_bf16_map(map, p, 4, dims, strides, box, sw);
}

template <int DP, int BN, bool kBias>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, int B, int H, int Tq, int Tk, int D, const int64_t* s,
           float scale, cudaStream_t stream) {
  using C = Cfg<DP, BN>;
  CUtensorMap qm, km, vm;
  int r = encode_map(&qm, q, B, H, Tq, D, s[0], s[1], s[2], C::PC, kRows);
  if (r == 0) r = encode_map(&km, k, B, H, Tk, D, s[3], s[4], s[5], C::PC, BN);
  if (r == 0) r = encode_map(&vm, v, B, H, Tk, D, s[6], s[7], s[8], C::PC, BN);
  if (r != 0) return r;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(flash_fwd_wgmma_kernel<DP, BN, kBias>,
                                       C::SmemBytes, smem_set);
  if (err != cudaSuccess) return int(err);
  dim3 grid((Tq + kRows - 1) / kRows, B * H);
  flash_fwd_wgmma_kernel<DP, BN, kBias><<<grid, C::Threads, C::SmemBytes,
                                          stream>>>(
      qm, km, vm, bias, static_cast<bf16*>(o), H, Tq, Tk, D, s[9], s[10],
      s[11], scale * kLog2e);
  return int(cudaGetLastError());
}

// 128-key tiles only up to DP = 64 (at 128 they lost on the H100)
template <int DP>
int launch_dp(const void* q, const void* k, const void* v, const float* bias,
              void* o, int B, int H, int Tq, int Tk, int D, const int64_t* s,
              float scale, int key_tile, cudaStream_t st) {
  if (key_tile == 64)
    return bias ? launch<DP, 64, true>(q, k, v, bias, o, B, H, Tq, Tk, D, s,
                                       scale, st)
                : launch<DP, 64, false>(q, k, v, bias, o, B, H, Tq, Tk, D, s,
                                        scale, st);
  if constexpr (DP <= 64) {
    if (key_tile == 128)
      return bias ? launch<DP, 128, true>(q, k, v, bias, o, B, H, Tq, Tk, D,
                                          s, scale, st)
                  : launch<DP, 128, false>(q, k, v, bias, o, B, H, Tq, Tk, D,
                                           s, scale, st);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace ns2vc

// bf16 q/k/v/o as (B, H, T, D) views given by element strides (batch, head,
// seq) with unit stride on D; bias (B, Tk) f32 contiguous or null;
// `key_tile` keys per tile: 64, or 128 for D <= 64. The
// caller guarantees 1 <= D <= 128 with D % 8 == 0, Tq >= 1, Tk >= 1,
// B*H <= 65535, q/k/v 16-byte aligned with strides of whole 16-byte chunks
// (TMA's rule), and o's rows 4-byte aligned.
// Returns the CUDA error of the launch (0 on success), or a negative code
// from a tensor map (-1: libcuda's encoder was not found; -(1000 + r): it
// returned CUresult r).
extern "C" int ns2vc_flash_attention_wgmma_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int B, int H, int Tq, int Tk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, float scale, int key_tile,
    void* stream) {
  const int64_t s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                         v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using ns2vc::launch_dp;
  if (D % 8 != 0 || D < 1) return int(cudaErrorInvalidValue);
  if (D <= 16)
    return launch_dp<16>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                         key_tile, st);
  if (D <= 32)
    return launch_dp<32>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                         key_tile, st);
  if (D <= 64)
    return launch_dp<64>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                         key_tile, st);
  if (D <= 128)
    return launch_dp<128>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                          key_tile, st);
  return int(cudaErrorInvalidValue);
}
