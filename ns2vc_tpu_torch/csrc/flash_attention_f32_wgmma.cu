// Flash attention forward on Hopper (sm_90a) with TMA and tf32 wgmma, f32
// in and out, at f32 accuracy through 3xTF32:
//     o = softmax(q.k^T * scale + key_bias) . v
//
// Replaces: ns2vc_tpu/ops/pallas_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`) for f32 inputs whose rows TMA can describe
// (D % 4 == 0, D <= 128, 16-byte aligned bases and strides); the wrapper
// sends other f32 rows of more than one query to flash_attention.cu
// (sub-route "f32tc_narrow"), calls of one query to flash_attention_q1.cu
// and bf16 calls to flash_attention_wgmma.cu.
//
// What bounds it on the H100: operations. f32 accuracy (the JAX suite's
// 2e-5; one TF32 pass errs by ~3e-4 of the output) takes three TF32 passes
// per product (3xTF32: big.big + big.small + small.big of each operand's
// TF32 halves), so the least time is 3 x 4 B H Tq Tk D FLOPs over 494.7
// TFLOP/s, and only wgmma reaches that rate. Three things stand between
// the tensor cores and that rate. (1) tf32 wgmma reads shared operands
// K-major only: Q.K^T can read K as TMA lays it down, but P.V needs V^T
// (head-dim rows over keys), so V must be transposed in shared memory, and
// every operand must be split into its two TF32 planes on the CUDA cores,
// once per key tile. (2) At the UNet's head dims (16-64) the softmax and
// the splitting of P cost more issue slots per score than the tensor cores
// take for its products, so the kernel is bound by the latency of each
// consumer's chain of products, softmax and waits unless they overlap.
// (3) The small grids (ContentVec's B*H = 12, the op registry's 8, B=1's 8)
// leave most SMs idle unless the keys are split.
// What the design does about it (after flash_attention_wgmma.cu and
// gn_silu_conv1d.cu's f32 route): one block per (64 x NC query rows, batch
// * head, key split), warp specialised into a converting warpgroup and NC
// (1 or 2) consumer warpgroups of 64 query rows each:
//   - the converting warpgroup: its thread 0 issues every TMA copy, the
//     consumers' Q tiles once and each key tile's raw K and V (BN keys)
//     into a staging slot each; q, k and v are 4-D tensor maps over
//     (D, H, T, B) of the strided views, so the packed (B, T, 3C)
//     self-attention projection goes in without a copy, and rows past T
//     and columns past D arrive as zeros. The warpgroup reads each raw
//     tile into registers, refills the slots at once (the next tile's copy
//     runs while this one is split and stored) and splits it into a ring
//     of 2-3 stages: K's TF32 big and small planes in K's own swizzled
//     layout (the B operand of Q.K^T), and V's two planes transposed
//     (head-dim rows of BN keys, 128-byte swizzle: the B operand of P.V),
//     each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7, so that the S
//     accumulator's (2t, 2t + 1) pair is P's A fragment (t, t + 4) and P
//     goes from the softmax into P.V with no shuffle (each thread takes
//     one half of such a group of 8 keys at 4 head dims, neighbours the
//     two halves, so that the transposed stores spread over the banks;
//     faster than whole groups per thread). It writes the key
//     bias beside each stage in the log2 domain, -inf past Tk; without a
//     bias (the UNet's self-attention) the consumers mask keys past Tk by
//     index in the last tile. With two consumers each converted tile feeds
//     128 query rows: half the conversions per product.
//   - each consumer warpgroup: its Q tile split once (big in place, small
//     beside); per key tile S = Q.K^T on wgmma m64nBNk8 tf32 with both
//     operands in shared memory (three passes a k-step, small terms first,
//     into a fresh accumulator), the online softmax in registers in the
//     log2 domain with one MUFU.EX2 per score, P split into its TF32
//     halves in registers, and P.V on wgmma m64nDPk8 tf32 with P from
//     registers (three passes) into a fresh accumulator that is added to
//     the rescaled running output with an FMA: the tensor cores' f32
//     accumulation truncates, and over 3000 keys that bias would grow.
//     Tile i's Q.K^T is issued together with tile i-1's P.V, and tile i's
//     softmax runs while that P.V is in flight.
//   - key splits: where the grid would leave SMs idle, the wrapper's
//     `plan_f32_wgmma` splits the key tiles over a thread block cluster of
//     up to 8 blocks; each writes its unnormalised rows, row max and row
//     sum to its shared memory, and every block combines the cluster's
//     partials for its share of the rows through distributed shared memory,
//     in order of rank (deterministic, no atomics, no workspace and no
//     second kernel).
// Every split rounds to TF32 with integer operations (`tf32_round`), not
// the conversion instruction. Measured on the H100 and not taken (PERF.md,
// `scripts/torch_k1_f32_variants.py`): the raw values as their own big
// planes with the remainder unrounded, which wgmma's truncation allows
// (20 % slower per UNet step), and from scratch runs the two consumers
// taking turns at the tensor cores (named barriers; slower at the key-bias
// calls), 128-key tiles, and S double-buffered with a third tile in flight
// (more registers through setmaxnreg; slower).
// The running max starts at -inf and a row whose max is still -inf
// subtracts 0, and the row sum is floored at 1e-30, so a fully masked row
// stays finite.
// Head dims: DP = 16 (64-byte swizzle), 32, 64 or 128 (128-byte panels);
// a head dim between takes the next DP (48 -> 64): TMA fills the columns
// past D with zeros, Q.K^T skips the k-steps past D, and the output's
// columns past D are not stored.
// Budgets (per block): Q's two planes per consumer (32 KB at DP = 64), the
// two raw slots, ST stages of four BN x DP planes (32 KB at DP = 64, BN =
// 32) and the stages' key bias: at most 230,656 of the 232,448 bytes a
// block may have ((DP, BN, NC) = (128, 32, 1), two stages; `Cfg::
// SmemBytes` and the wrapper's `f32_wgmma_smem` agree). 256 threads (NC =
// 1) may use 255 registers, 384 (NC = 2) 168: a consumer holds its running
// output and the tile's partial (DP / 2 each), S (BN / 2) and P's two
// halves (BN); ptxas's register and spill report per instantiation is in
// the build log (none spills).
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;     // query rows per consumer warpgroup
constexpr int kGroup = 128;   // threads of a warpgroup
constexpr int kSmemLimit = 232448;

template <int DP, int BN, int NC>
struct Cfg {
  static constexpr int W = DP < 32 ? 4 * DP : 128;  // Q / K row bytes per panel
  static constexpr int PC = W / 4;                  // head columns per panel
  static constexpr int NP = DP / PC;                // panels
  static constexpr int CPR = DP / 4;                // 16-byte chunks per row
  static constexpr int QPanel = kRows * W;
  static constexpr int QPlane = NP * QPanel;        // one plane of one consumer
  static constexpr int KPanel = BN * W;
  static constexpr int Tile = NP * KPanel;          // BN x DP floats
  static constexpr int VPanel = DP * 128;           // V^T: DP rows of 32 keys
  static constexpr int Threads = kGroup * (1 + NC);
  static constexpr int Fixed = 1024 + 2 * NC * QPlane + 2 * Tile;
  static constexpr int StageBytes = 4 * Tile + BN * 4;
  static constexpr int Stages =
      Fixed + 3 * StageBytes <= kSmemLimit ? 3 : 2;
  static constexpr int SmemBytes = Fixed + Stages * StageBytes;
  // the cluster's partial rows (DP + 4 floats) and their max and sum
  static constexpr int PartStride = DP + 4;
  static_assert(SmemBytes <= kSmemLimit, "shared memory of one block");
  static_assert(NC * kRows * (PartStride + 2) * 4 <= SmemBytes - 1024,
                "partial tile");
  static_assert(Tile % 1024 == 0 && QPanel % 512 == 0, "atom alignment");
};

// the swizzled place of 16-byte chunk `chunk` of row `row` in a tile of
// W-byte rows (W = 64 or 128)
template <int W>
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  if constexpr (W == 128) {
    return swz128(base, row, chunk);
  } else {
    return swz64(base, row, chunk);
  }
}

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna) with
// integer operations at the full ALU rate: with the conversion
// instruction, which runs at a fraction of it, the splits of K, V, Q and
// every probability made a UNet step 15 % slower
// (`scripts/torch_k1_f32_variants.py`, cvt)
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 3xTF32's halves (as mma.cuh's split_tf32): big = x rounded, small = the
// exact remainder rounded
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& big,
                                               uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const uint4 v, uint4& big,
                                       uint4& small) {
  split_tf32_int(__uint_as_float(v.x), big.x, small.x);
  split_tf32_int(__uint_as_float(v.y), big.y, small.y);
  split_tf32_int(__uint_as_float(v.z), big.z, small.z);
  split_tf32_int(__uint_as_float(v.w), big.w, small.w);
}

__device__ __forceinline__ uint32_t lane_of(const uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DP, int BN, int NC, bool kBias>
__global__ void __launch_bounds__(Cfg<DP, BN, NC>::Threads, 1)
flash_fwd_f32_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const float* __restrict__ bias,
                           float* __restrict__ o, int H, int Tq, int Tk,
                           int D, int64_t o_sb, int64_t o_sh, int64_t o_st,
                           float scale_log2, int tiles_per_split) {
  using C = Cfg<DP, BN, NC>;
  constexpr int ST = C::Stages, W = C::W;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * ST];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // Q: consumer c's big plane (where its copy lands), then its small one
  auto q_plane = [&](int c, int p) { return base + (2 * c + p) * C::QPlane; };
  const uint32_t kraw = base + 2 * NC * C::QPlane, vraw = kraw + C::Tile;
  // stage s: K big, K small, V^T big, V^T small
  auto plane = [&](int s, int p) {
    return vraw + C::Tile + (4 * s + p) * C::Tile;
  };
  float* bias_s = reinterpret_cast<float*>(
      smem_raw + (base - raw) + 2 * NC * C::QPlane + (2 + 4 * ST) * C::Tile);
  const uint32_t qfull = smem_u32(&bars[0]), rawfull = smem_u32(&bars[1]);
  auto ready = [&](int s) { return smem_u32(&bars[2 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[2 + ST + s]); };

  const int tid = threadIdx.x, wg = tid / kGroup, lane = tid & 31;
  const int gt = tid % kGroup;   // thread in its warpgroup
  const int splits = gridDim.x, split = blockIdx.x;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kRows * NC;
  const int nact = min(NC, (Tq - q0 + kRows - 1) / kRows);
  const int n_tiles = (Tk + BN - 1) / BN;
  const int j0 = split * tiles_per_split;
  const int n = min(n_tiles, j0 + tiles_per_split) - j0;   // >= 1

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(rawfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(ready(s), kGroup);         // every converting thread
      mbar_init(empty(s), nact * kGroup);  // every active consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_kv = [&](int j) {
    mbar_arrive_expect_tx(rawfull, 2 * C::Tile);
#pragma unroll
    for (int p = 0; p < C::NP; ++p) {
      tma_load_4d(kraw + p * C::KPanel, &kmap, rawfull, p * C::PC, h, j * BN,
                  b);
      tma_load_4d(vraw + p * C::KPanel, &vmap, rawfull, p * C::PC, h, j * BN,
                  b);
    }
  };

  float O[DP / 2], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) O[e] = 0.f;
  const int c = wg - 1;   // this consumer (wg >= 1)

  if (wg == 0) {
    // converting warpgroup: the copies, and each tile's four planes
    if (gt == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      mbar_arrive_expect_tx(qfull, nact * C::QPlane);
      for (int cc = 0; cc < nact; ++cc)
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          tma_load_4d(q_plane(cc, 0) + p * C::QPanel, &qmap, qfull, p * C::PC,
                      h, q0 + cc * kRows, b);
      load_kv(j0);
    }
    const float* brow = kBias ? bias + int64_t(b) * Tk : nullptr;
    // each thread's K chunks and V items of a tile. A V item is one half
    // (keys 0, 2, 4, 6 or 1, 3, 5, 7) of a group g8 of 8 keys at one
    // 16-byte chunk vch of head dims; neighbouring threads take the two
    // halves, so a warp's transposed stores spread over the banks
    constexpr int KPT = (BN * C::CPR + kGroup - 1) / kGroup;
    constexpr int VItems = 2 * (BN / 8) * C::CPR;
    constexpr int VPT = (VItems + kGroup - 1) / kGroup;
    auto vitem = [&](int t, int& half, int& vch, int& g8) {
      const int e = gt + t * kGroup;
      half = e & 1;
      vch = (e >> 1) % C::CPR;
      g8 = (e >> 1) / C::CPR;
      return e < VItems;
    };
    auto koff = [&](int e) {   // chunk e of a K tile, in its layout
      const int row = e / C::CPR, ch = e % C::CPR;
      return (ch / (C::PC / 4)) * C::KPanel + swz<W>(0, row, ch % (C::PC / 4));
    };
    for (int i = 0; i < n; ++i) {
      const int s = i % ST, j = j0 + i;
      // the raw tiles into registers, so that the slots refill at once
      // and the next tile's copy runs while this one is split and stored
      mbar_wait(rawfull, i & 1);
      uint4 kr[KPT], x[VPT][4];
#pragma unroll
      for (int t = 0; t < KPT; ++t)
        if (gt + t * kGroup < BN * C::CPR)
          kr[t] = lds128(kraw + koff(gt + t * kGroup));
#pragma unroll
      for (int t = 0; t < VPT; ++t) {
        int half, vch, g8;
        if (vitem(t, half, vch, g8)) {
          const uint32_t src = vraw + (vch / (C::PC / 4)) * C::KPanel;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            x[t][r] = lds128(
                swz<W>(src, 8 * g8 + half + 2 * r, vch % (C::PC / 4)));
        }
      }
      fence_proxy_async();   // the raw slots' reads, before TMA refills them
      named_barrier_sync(1, kGroup);
      if (gt == 0 && i + 1 < n) load_kv(j + 1);
      if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
      const uint32_t kb = plane(s, 0), ks = plane(s, 1);
      const uint32_t vb = plane(s, 2), vs = plane(s, 3);
      // K: both planes in K's own layout (chunk for chunk)
#pragma unroll
      for (int t = 0; t < KPT; ++t) {
        if (gt + t * kGroup < BN * C::CPR) {
          const uint32_t off = koff(gt + t * kGroup);
          uint4 big, small;
          split4(kr[t], big, small);
          sts128(kb + off, big);
          sts128(ks + off, small);
        }
      }
      // V: item (half, vch, g8) -> for each of the head dims 4 vch ..
      // 4 vch + 3, one 16-byte chunk of V^T's row: the half's 4 keys
#pragma unroll
      for (int t = 0; t < VPT; ++t) {
        int half, vch, g8;
        if (vitem(t, half, vch, g8)) {
          const uint32_t vpanel = (g8 / 4) * C::VPanel;
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) {
            const uint4 vals = make_uint4(
                lane_of(x[t][0], dd), lane_of(x[t][1], dd),
                lane_of(x[t][2], dd), lane_of(x[t][3], dd));
            uint4 big, small;
            split4(vals, big, small);
            const uint32_t off =
                swz128(vpanel, 4 * vch + dd, 2 * (g8 % 4) + half);
            sts128(vb + off, big);
            sts128(vs + off, small);
          }
        }
      }
      if (kBias) {
        float* bs = bias_s + s * BN;
        for (int kk = gt; kk < BN; kk += kGroup) {
          const int key = j * BN + kk;
          bs[kk] = key < Tk ? brow[key] * kLog2e : -CUDART_INF_F;
        }
      }
      fence_proxy_async();   // the planes, before wgmma reads them
      mbar_arrive(ready(s));
    }
  } else if (c < nact) {
    const int w = (tid / 32) % 4, g = lane >> 2, qd = lane & 3;
    const uint32_t qb = q_plane(c, 0), qs = q_plane(c, 1);
    const int ksteps = (D + 7) / 8;
    // Q in place: its big plane over the copy, its small plane beside
    mbar_wait(qfull, 0);
    for (int e = gt; e < kRows * C::CPR; e += kGroup) {
      const int row = e / C::CPR, ch = e % C::CPR;
      const uint32_t off = (ch / (C::PC / 4)) * C::QPanel +
                           swz<W>(0, row, ch % (C::PC / 4));
      uint4 big, small;
      split4(lds128(qb + off), big, small);
      sts128(qb + off, big);
      sts128(qs + off, small);
    }
    fence_proxy_async();
    named_barrier_sync(2 + c, kGroup);

    float S[BN / 2], Op[DP / 2], alpha[2] = {0.f, 0.f};
    uint32_t Pb[BN / 8][4], Ps[BN / 8][4];
    // S = Q.K^T of the tile in stage s: per k-step small.big, big.small,
    // big.big, into S afresh
    auto qk = [&](int s) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) S[e] = 0.f;   // ends S's live range
      wgmma_fence();
#pragma unroll
      for (int kst = 0; kst < DP / 8; ++kst) {
        if (kst < ksteps) {   // k-steps past D would add zeros
          const uint32_t off = (kst * 8 % C::PC) * 4;
          const int pnl = kst * 8 / C::PC;
          const uint64_t ab =
              wgmma_desc<W>(qb + pnl * C::QPanel + off, 16, 8 * W);
          const uint64_t as =
              wgmma_desc<W>(qs + pnl * C::QPanel + off, 16, 8 * W);
          const uint64_t bb =
              wgmma_desc<W>(plane(s, 0) + pnl * C::KPanel + off, 16, 8 * W);
          const uint64_t bsm =
              wgmma_desc<W>(plane(s, 1) + pnl * C::KPanel + off, 16, 8 * W);
          wgmma_tf32_ss<BN>(S, as, bb, kst > 0);
          wgmma_tf32_ss<BN>(S, ab, bsm, 1);
          wgmma_tf32_ss<BN>(S, ab, bb, 1);
        }
      }
      wgmma_commit();
    };
    // P.V of the tile in stage s into the fresh partial Op: small.big,
    // big.small, big.big
    auto pv = [&](int s) {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) Op[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t off = (kk / 4) * C::VPanel + (kk % 4) * 32;
        const uint64_t vbd = wgmma_desc<128>(plane(s, 2) + off, 16, 1024);
        const uint64_t vsd = wgmma_desc<128>(plane(s, 3) + off, 16, 1024);
        wgmma_tf32_rs<DP>(Op, Ps[kk], vbd, kk > 0);
        wgmma_tf32_rs<DP>(Op, Pb[kk], vsd, 1);
        wgmma_tf32_rs<DP>(Op, Pb[kk], vbd, 1);
      }
      wgmma_commit();
    };
    // the online softmax of tile j (stage s) in S, log2 domain: the new
    // running max, the rescale factor of what came before (alpha), the
    // row sums. With a key bias: logits s * scale + bias (-inf past Tk),
    // then 2^(x - max). Without one the max is taken over the raw scores
    // (scale > 0) and 2^(s * scale - max) is one FMA and one MUFU.EX2;
    // keys past Tk become -inf in the last tile only.
    auto softmax = [&](int j, int s) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) fence_operand(S[e]);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if constexpr (kBias) {
        const float* bs = bias_s + s * BN;
#pragma unroll
        for (int cc = 0; cc < BN / 8; ++cc) {
          const float2 bb =
              *reinterpret_cast<const float2*>(bs + 8 * cc + 2 * qd);
          S[4 * cc] = fmaf(S[4 * cc], scale_log2, bb.x);
          S[4 * cc + 1] = fmaf(S[4 * cc + 1], scale_log2, bb.y);
          S[4 * cc + 2] = fmaf(S[4 * cc + 2], scale_log2, bb.x);
          S[4 * cc + 3] = fmaf(S[4 * cc + 3], scale_log2, bb.y);
        }
      } else if (j * BN + BN > Tk) {
        const int left = Tk - j * BN;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          if (8 * (e >> 2) + 2 * qd + (e & 1) >= left) S[e] = -CUDART_INF_F;
      }
#pragma unroll
      for (int cc = 0; cc < BN / 8; ++cc) {
        mx[0] = fmaxf(mx[0], fmaxf(S[4 * cc], S[4 * cc + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(S[4 * cc + 2], S[4 * cc + 3]));
      }
      float ref[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if (!kBias) mx[r] *= scale_log2;
        mx[r] = fmaxf(mx[r], m[r]);
        ref[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r];
        alpha[r] = ex2_approx(m[r] - ref[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int r = (e >> 1) & 1;
        S[e] = ex2_approx(kBias ? S[e] - ref[r]
                                : fmaf(S[e], scale_log2, -ref[r]));
        sum[r] += S[e];
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
    };
    // P's TF32 halves as the A fragments of P.V (keys in V^T's order)
    auto to_p = [&] {
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        split_tf32_int(S[4 * kk], Pb[kk][0], Ps[kk][0]);
        split_tf32_int(S[4 * kk + 2], Pb[kk][1], Ps[kk][1]);
        split_tf32_int(S[4 * kk + 1], Pb[kk][2], Ps[kk][2]);
        split_tf32_int(S[4 * kk + 3], Pb[kk][3], Ps[kk][3]);
      }
    };
    // after P.V of a tile: release its stage, fold its partial into the
    // running output (rescaled by that tile's alpha) with an FMA
    auto fold = [&](int s, const float (&a)[2]) {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) fence_operand(Op[e]);
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(Pb[kk][e]);
          fence_operand(Ps[kk][e]);
        }
      mbar_arrive(empty(s));
#pragma unroll
      for (int e = 0; e < DP / 2; ++e)
        O[e] = fmaf(O[e], a[(e >> 1) & 1], Op[e]);
    };

    mbar_wait(ready(0), 0);
    qk(0);
    wgmma_wait<0>();
    softmax(j0, 0);
    to_p();
    for (int i = 1; i < n; ++i) {
      const int s = i % ST, sp = (i - 1) % ST;
      mbar_wait(ready(s), (i / ST) & 1);
      qk(s);        // tile i's scores ...
      pv(sp);       // ... and tile i-1's P.V in flight together
      wgmma_wait<1>();
      const float ap[2] = {alpha[0], alpha[1]};
      softmax(j0 + i, s);   // tile i's softmax while P.V runs
      wgmma_wait<0>();
      fold(sp, ap);
      to_p();
    }
    pv((n - 1) % ST);
    wgmma_wait<0>();
    fold((n - 1) % ST, alpha);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (splits == 1) {
      float* ob = o + int64_t(b) * o_sb + int64_t(h) * o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = q0 + c * kRows + 16 * w + g + 8 * r;
        if (t >= Tq) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        float* orow = ob + int64_t(t) * o_st;
#pragma unroll
        for (int jn = 0; jn < DP / 8; ++jn) {
          const int d = 8 * jn + 2 * qd;   // D % 4 == 0: d < D => d + 1 < D
          if (d < D)
            *reinterpret_cast<float2*>(orow + d) =
                make_float2(O[4 * jn + 2 * r] * inv,
                            O[4 * jn + 2 * r + 1] * inv);
        }
      }
    }
  }
  if (splits == 1) return;

  // key splits: every block's partial rows, max and sum in its shared
  // memory (the stages are free: every copy has landed and every product
  // has read its operands), then each block combines its share of the rows
  __syncthreads();
  constexpr int PS = C::PartStride, R = NC * kRows;
  float* part = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* ml = part + R * PS;
  if (wg >= 1 && c < nact) {
    const int w = (tid / 32) % 4, g = lane >> 2, qd = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c * kRows + 16 * w + g + 8 * r;
#pragma unroll
      for (int jn = 0; jn < DP / 8; ++jn)
        *reinterpret_cast<float2*>(part + row * PS + 8 * jn + 2 * qd) =
            make_float2(O[4 * jn + 2 * r], O[4 * jn + 2 * r + 1]);
      if (qd == 0) {
        ml[2 * row] = m[r];
        ml[2 * row + 1] = l[r];
      }
    }
  }
  cluster_sync();
  const int rb = split * R / splits, re = (split + 1) * R / splits;
  const uint32_t part_u = base, ml_u = base + R * PS * 4;
  float* ob = o + int64_t(b) * o_sb + int64_t(h) * o_sh;
  for (int e = tid; e < (re - rb) * (DP / 4); e += C::Threads) {
    const int row = rb + e / (DP / 4), col = (e % (DP / 4)) * 4;
    const int t = q0 + row;
    if (t >= Tq || col >= D) continue;
    float mx = -CUDART_INF_F;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, ld_cluster_f32(map_to_rank(ml_u + row * 8, r)));
    const float ref = mx == -CUDART_INF_F ? 0.f : mx;
    // the splits' partials in a fixed order: rank 0's, rank 1's, ...
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float wr =
          ex2_approx(ld_cluster_f32(map_to_rank(ml_u + row * 8, r)) - ref);
      lsum = fmaf(ld_cluster_f32(map_to_rank(ml_u + row * 8 + 4, r)), wr,
                  lsum);
      const float4 p =
          ld_cluster_f32x4(map_to_rank(part_u + (row * PS + col) * 4, r));
      acc.x = fmaf(p.x, wr, acc.x);
      acc.y = fmaf(p.y, wr, acc.y);
      acc.z = fmaf(p.z, wr, acc.z);
      acc.w = fmaf(p.w, wr, acc.w);
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    *reinterpret_cast<float4*>(ob + int64_t(t) * o_st + col) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
  cluster_sync();   // the peers have read this block's partials
}

// one operand's f32 tensor map: (D, H, T, B) with element strides (sh, st,
// sb), a box of PC columns x `rows` rows of one head, swizzled as the
// kernel's tiles (64 bytes at PC = 16, else 128)
int encode_map(CUtensorMap* map, const void* p, int B, int H, int T, int D,
               int64_t sb, int64_t sh, int64_t st, int pc, int rows) {
  const int64_t outer[3][2] = {{sh, H}, {st, T}, {sb, B}};
  uint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of one element is never stepped over: any multiple of
    // 16 bytes will do for its stride
    const uint64_t s = uint64_t(outer[i][0]) * 4;
    strides[i] = outer[i][1] > 1 || (s > 0 && s % 16 == 0) ? s : 16;
  }
  const uint64_t dims[4] = {uint64_t(D), uint64_t(H), uint64_t(T),
                            uint64_t(B)};
  const uint32_t box[4] = {uint32_t(pc), 1, uint32_t(rows), 1};
  return encode_f32_map(map, p, 4, dims, strides, box,
                        pc == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DP, int BN, int NC, bool kBias>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, int B, int H, int Tq, int Tk, int D, const int64_t* s,
           float scale, int splits, cudaStream_t stream) {
  using C = Cfg<DP, BN, NC>;
  const int n_tiles = (Tk + BN - 1) / BN;
  const int per = (n_tiles + splits - 1) / splits;
  if (splits < 1 || splits > 8 || (splits - 1) * per >= n_tiles)
    return int(cudaErrorInvalidValue);   // an empty split
  CUtensorMap qm, km, vm;
  int r = encode_map(&qm, q, B, H, Tq, D, s[0], s[1], s[2], C::PC, kRows);
  if (r == 0) r = encode_map(&km, k, B, H, Tk, D, s[3], s[4], s[5], C::PC, BN);
  if (r == 0) r = encode_map(&vm, v, B, H, Tk, D, s[6], s[7], s[8], C::PC, BN);
  if (r != 0) return r;
  auto kernel = flash_fwd_f32_wgmma_kernel<DP, BN, NC, kBias>;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(kernel, C::SmemBytes, smem_set);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (Tq + kRows * NC - 1) / (kRows * NC), B * H);
  cfg.blockDim = dim3(C::Threads);
  cfg.dynamicSmemBytes = C::SmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, qm, km, vm, bias,
                           static_cast<float*>(o), H, Tq, Tk, D, s[9], s[10],
                           s[11], scale * kLog2e, per);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <int DP, int BN, int NC>
int launch_bias(const void* q, const void* k, const void* v,
                const float* bias, void* o, int B, int H, int Tq, int Tk,
                int D, const int64_t* s, float scale, int splits,
                cudaStream_t st) {
  return bias ? launch<DP, BN, NC, true>(q, k, v, bias, o, B, H, Tq, Tk, D,
                                         s, scale, splits, st)
              : launch<DP, BN, NC, false>(q, k, v, bias, o, B, H, Tq, Tk, D,
                                          s, scale, splits, st);
}

// the instantiated (key tile, consumers) of each padded head dim: 64-key
// tiles with one or two consumers up to DP = 32; at DP = 64 64-key tiles
// with one consumer or 32-key tiles with two; 32-key tiles with one at
// DP = 128 (what fits a consumer's registers: 255 with one consumer, 168
// with two); `plan_f32_wgmma` picks among them
template <int DP>
int launch_dp(const void* q, const void* k, const void* v, const float* bias,
              void* o, int B, int H, int Tq, int Tk, int D, const int64_t* s,
              float scale, int key_tile, int consumers, int splits,
              cudaStream_t st) {
  if constexpr (DP <= 64) {
    if (key_tile == 64 && consumers == 1)
      return launch_bias<DP, 64, 1>(q, k, v, bias, o, B, H, Tq, Tk, D, s,
                                    scale, splits, st);
  }
  if constexpr (DP <= 32) {
    if (key_tile == 64 && consumers == 2)
      return launch_bias<DP, 64, 2>(q, k, v, bias, o, B, H, Tq, Tk, D, s,
                                    scale, splits, st);
  }
  if constexpr (DP == 64) {
    if (key_tile == 32 && consumers == 2)
      return launch_bias<DP, 32, 2>(q, k, v, bias, o, B, H, Tq, Tk, D, s,
                                    scale, splits, st);
  }
  if constexpr (DP == 128) {
    if (key_tile == 32 && consumers == 1)
      return launch_bias<DP, 32, 1>(q, k, v, bias, o, B, H, Tq, Tk, D, s,
                                    scale, splits, st);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace ns2vc

// f32 q/k/v/o as (B, H, T, D) views given by element strides (batch, head,
// seq) with unit stride on D; bias (B, Tk) f32 contiguous or null;
// `key_tile` keys per tile and `consumers` warpgroups of 64 query rows per
// block, one of the instantiated pairs (`launch_dp`); the key tiles split
// evenly over `splits` (1..8) blocks of a cluster, none empty. The caller
// guarantees 1 <= D <= 128 with D % 4 == 0, Tq >= 1, Tk >= 1, B*H <= 65535,
// scale > 0, q/k/v 16-byte aligned with strides of whole 16-byte chunks
// (TMA's rule), and o's rows 16-byte aligned.
// Returns the CUDA error of the launch (0 on success), or a negative code
// from a tensor map (-1: libcuda's encoder was not found; -(1000 + r): it
// returned CUresult r).
extern "C" int ns2vc_flash_attention_f32_wgmma_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int B, int H, int Tq, int Tk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, float scale, int key_tile,
    int consumers, int splits, void* stream) {
  const int64_t s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                         v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using ns2vc::launch_dp;
  if (D % 4 != 0 || D < 1) return int(cudaErrorInvalidValue);
  if (D <= 16)
    return launch_dp<16>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                         key_tile, consumers, splits, st);
  if (D <= 32)
    return launch_dp<32>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                         key_tile, consumers, splits, st);
  if (D <= 64)
    return launch_dp<64>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                         key_tile, consumers, splits, st);
  if (D <= 128)
    return launch_dp<128>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale,
                          key_tile, consumers, splits, st);
  return int(cudaErrorInvalidValue);
}
