// Flash attention backward on Hopper (sm_90a), f32 in and out, at f32
// accuracy through 3xTF32 on tf32 wgmma: given
//     o = softmax(q.k^T * scale + key_bias) . v
// and o's gradient dO, it computes
//     P = softmax(q.k^T * scale + key_bias)           (recomputed, f32)
//     dV = P^T . dO,  dP = dO . V^T,  Delta = rowsum(P * dP)
//     dS = P * (dP - Delta),  dQ = dS . K * scale,  dK = dS^T . Q * scale
// q, k, v, dO (B, H, T, D) f32 views through (batch, head, seq) strides,
// the key bias (B, Tk) f32 (0 keep, -1e4 drop) or none; dq, dk, dv f32
// through their strides.
//
// Replaces: the torch-ops backward `ops/flash_attention.py::
// flash_attention_backward` (which stays as the plain version) for f32
// calls, and through it XLA's autodiff of ns2vc_tpu/ops/attention.py::
// scaled_dot_product_attention, the function the Pallas TPU kernel
// ns2vc_tpu/ops/pallas_attention.py::flash_attention computes (forward
// only). Its callers: the F0 predictor's f32 cross-attentions in every
// step of a model with the predictor (B = 32, H = 8, Tq = Tk = 272, D =
// 32, key bias) and the f32 gradient checks (the UNet's heads at D = 16,
// 32, 48, 64 and the encoders' at 32).
//
// What bounds it on the H100: operations. f32 accuracy takes three TF32
// passes per product (big.big + big.small + small.big of each operand's
// TF32 halves), five products of 2 B H Tq Tk D FLOPs: at the F0
// cross-attention 3 x 6.05 GFLOP over 494.7 TFLOP/s, 0.037 ms a call.
// tf32 wgmma reads shared operands K-major only, so three of the five
// products need an operand transposed in shared memory (dQ = dS.K needs
// K^T, dV = P^T.dO dO^T and dK = dS^T.Q Q^T), and every operand is split
// into its two TF32 planes on the CUDA cores once per tile.
// Design: the bf16 backward's two kernels (flash_attention_bwd_wgmma.cu)
// in the f32 forward's form (flash_attention_f32_wgmma.cu): each block is
// a converting warpgroup and one consumer warpgroup of 64 fixed rows, no
// atomics:
//   - `dq`, one block per (64 query rows, batch*head): Q and dO once,
//     split by the consumer in place (big over the copy, small beside);
//     every key tile of BN keys twice. The converting warpgroup's thread 0
//     issues the TMA copies (4-D f32 maps of the strided views: rows past
//     T and columns past D arrive as zeros) into one raw slot per operand;
//     the warpgroup reads each raw tile into registers, refills the slots
//     at once, and writes K's and V's planes in their own swizzled layout
//     (the B operands of S = Q.K^T and dP = dO.V^T) and, in sweep 2, K^T's
//     planes (head-dim rows of the tile's keys, each 8 keys in the order
//     0, 2, 4, 6, 1, 3, 5, 7, so that the accumulator's (2t, 2t + 1) pair
//     of dS is the A fragment's (t, t + 4) and dS goes from registers into
//     dQ with no shuffle), with the key bias in the log2 domain (-inf past
//     Tk) beside each stage of a ring. Sweep 1: S and dP on wgmma m64nBNk8
//     tf32 (three passes, small terms first, both operands in shared
//     memory), the logits in the log2 domain and per row, online, the max
//     m, l = sum 2^(x - m) and u = sum 2^(x - m) dP; then lse = m +
//     log2(l) and Delta = u / l into the workspace (rows past Tq: lse =
//     +inf, Delta = 0). Delta comes from the kernel's own f32 P and dP,
//     never from O: dS = P (dP - Delta) cancels where dP ~ Delta, and a
//     Delta that is not the same sum the row's P and dP give would carry
//     the difference into every element of the row. Sweep 2: S and dP
//     again, dS split into its TF32 planes in registers, dQ += dS.K^T's
//     planes on wgmma m64nDPk8 tf32 with dS from registers (three passes);
//   - `dkdv`, one block per (64 keys, batch*head): K and V once, split in
//     place; every query tile of BN queries: Q's and dO's planes (B of
//     S^T = K.Q^T and dP^T = V.dO^T, keys along wgmma's M) and Q^T's and
//     dO^T's (B of dK and dV, queries in the permuted order), that tile's
//     lse and Delta from the workspace; P^T = 2^(x - lse), dS^T = P^T
//     (dP^T - Delta); dV += P^T.dO^T's planes, then dK += dS^T.Q^T's, A from
//     registers (one set of plane registers for both, in turn).
// Tiles: BN = 64 at DP = 16 and 32, 32 at DP = 64, 16 at DP = 128 (what
// fits shared memory: a ring of 6 (dq) or 8 (dkdv) BN-row planes per stage
// beside the fixed tile's four planes and the raw slots), 3 stages where
// they fit the 232,448 bytes a block may have, else 2, else 1 (DP = 128:
// the fixed tile's four planes alone take 128 KB; its 16-key transposes
// are one 64-byte swizzled panel, its products m64n16k8). At DP = 128 the
// accumulators of dkdv (dK and dV, 64 floats each) fit a consumer's
// registers beside the 16-wide S and dP. Measured on an H100 and not
// kept (PERF.md): two raw slots per operand and, in dq's second
// sweep, tile j+1's products issued before tile j's dQ (no gain at the F0
// step's calls; dq's registers 124 -> 170): the converting warpgroup's
// work per tile sets the pace. One block of
// 256 threads per SM (the planes of one block take most of its shared
// memory); ptxas's register and spill report per instantiation is in the
// build log.
// Every split rounds to TF32 to nearest, ties away from zero, with
// integer operations (as cvt.rna and as ops/fused_resnet.py::tf32_round),
// and every sum runs in an order fixed by the shapes (wgmma's within a
// product, the tiles in order, a row's four lanes by xor shuffles), so two
// launches on one input give bitwise-equal outputs. A fully masked row
// (every key at -1e4) has a finite max and stays finite. Head dims: DP =
// 16 (64-byte swizzle), 32, 64 or 128 (128-byte); 48 takes 64, 100 takes
// 128 (TMA fills the columns past D with zeros, the products skip the
// k-steps past D, and the columns past D are not stored). Rows TMA cannot
// take (D % 4 != 0, unaligned) come from the wrapper as zero-padded
// contiguous copies ("f32tc_pad").
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;     // the fixed tile's rows: queries or keys
constexpr int kGroup = 128;   // threads of a warpgroup
constexpr int kThreads = 2 * kGroup;
constexpr int kSmemLimit = 232448;

// a tile of R rows of DP f32 in W-byte swizzled panels (the TMA box's
// layout, rows along M or N and K contiguous: K-major), and its transpose
// (DP rows of R keys in TW-byte swizzled panels of KP keys: 32 keys a
// 128-byte panel, 16 keys one 64-byte panel at R = 16)
template <int DP, int R>
struct Rows {
  static constexpr int W = DP < 32 ? 4 * DP : 128;
  static constexpr int PC = W / 4;                  // columns per panel
  static constexpr int NP = DP / PC;                // panels
  static constexpr int CPR = DP / 4;                // 16-byte chunks a row
  static constexpr int Panel = R * W;
  static constexpr int Plane = NP * Panel;
  static constexpr int Chunks = R * CPR;
  static constexpr int PerThread = (Chunks + kGroup - 1) / kGroup;
  static constexpr int TW = R >= 32 ? 128 : 4 * R;
  static constexpr int KP = TW / 4;                 // keys per transposed panel
  static constexpr int TPanel = DP * TW;
  // a transposed item: one half of a group of 8 rows at one 16-byte chunk
  static constexpr int TItems = 2 * (R / 8) * CPR;
  static constexpr int TPerThread = (TItems + kGroup - 1) / kGroup;
  static_assert(Plane % 1024 == 0 && TPanel % (8 * TW) == 0,
                "atom alignment");
  static_assert(R % KP == 0 && KP % 16 == 0,
                "whole panels of the transpose");
};

template <int DP, int BN, int PlanesPerStage, int RowFloats>
struct Cfg {
  using F = Rows<DP, kRows>;
  using R = Rows<DP, BN>;
  // the fixed tile's four planes, a raw slot of each streamed operand
  static constexpr int Fixed = 1024 + 4 * F::Plane + 2 * R::Plane;
  static constexpr int Stage = PlanesPerStage * R::Plane + RowFloats * 4;
  static constexpr int Stages = Fixed + 3 * Stage <= kSmemLimit   ? 3
                                : Fixed + 2 * Stage <= kSmemLimit ? 2
                                                                  : 1;
  static constexpr int SmemBytes = Fixed + Stages * Stage;
  static_assert(SmemBytes <= kSmemLimit, "shared memory of one block");
};

template <int DP, int BN>
using DqCfg = Cfg<DP, BN, 6, BN>;        // K, V, K^T planes; key bias
template <int DP, int BN>
using DkdvCfg = Cfg<DP, BN, 8, 2 * BN>;  // Q, dO, Q^T, dO^T; lse, Delta

template <int W>
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  if constexpr (W == 128) {
    return swz128(base, row, chunk);
  } else {
    return swz64(base, row, chunk);
  }
}

// f32 -> TF32, to nearest, ties away from zero (cvt.rna), by integer
// operations at the full ALU rate (flash_attention_f32_wgmma.cu)
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const uint4 v, uint4& big,
                                       uint4& small) {
  split_tf32(__uint_as_float(v.x), big.x, small.x);
  split_tf32(__uint_as_float(v.y), big.y, small.y);
  split_tf32(__uint_as_float(v.z), big.z, small.z);
  split_tf32(__uint_as_float(v.w), big.w, small.w);
}

__device__ __forceinline__ uint32_t lane_of(const uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// byte offset of 16-byte chunk e (row e / CPR) of a row tile
template <typename T>
__device__ __forceinline__ uint32_t chunk_off(int e) {
  const int row = e / T::CPR, ch = e % T::CPR;
  return (ch / (T::PC / 4)) * T::Panel +
         swz<T::W>(0, row, ch % (T::PC / 4));
}

// transposed item t of this thread: (half, 16-byte chunk, group of 8 rows)
template <typename T>
__device__ __forceinline__ bool titem(int gt, int t, int& half, int& ch,
                                      int& g8) {
  const int e = gt + t * kGroup;
  half = e & 1;
  ch = (e >> 1) % T::CPR;
  g8 = (e >> 1) / T::CPR;
  return e < T::TItems;
}

// a raw row tile's chunks of this thread into registers
template <typename T>
__device__ __forceinline__ void read_rows(uint32_t raw, int gt,
                                          uint4 (&r)[T::PerThread]) {
#pragma unroll
  for (int t = 0; t < T::PerThread; ++t)
    if (gt + t * kGroup < T::Chunks) r[t] = lds128(raw + chunk_off<T>(gt + t * kGroup));
}

// ... and its planes, big and small, in the tile's own layout
template <typename T>
__device__ __forceinline__ void write_rows(uint32_t big, uint32_t small,
                                           int gt,
                                           const uint4 (&r)[T::PerThread]) {
#pragma unroll
  for (int t = 0; t < T::PerThread; ++t) {
    if (gt + t * kGroup < T::Chunks) {
      const uint32_t off = chunk_off<T>(gt + t * kGroup);
      uint4 b, s;
      split4(r[t], b, s);
      sts128(big + off, b);
      sts128(small + off, s);
    }
  }
}

// a raw row tile's transposed items of this thread into registers: 4 rows
// (8 g8 + half + 2 j) at one chunk each
template <typename T>
__device__ __forceinline__ void read_trans(uint32_t raw, int gt,
                                           uint4 (&x)[T::TPerThread][4]) {
#pragma unroll
  for (int t = 0; t < T::TPerThread; ++t) {
    int half, ch, g8;
    if (titem<T>(gt, t, half, ch, g8)) {
      const uint32_t src = raw + (ch / (T::PC / 4)) * T::Panel;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[t][j] = lds128(swz<T::W>(src, 8 * g8 + half + 2 * j, ch % (T::PC / 4)));
    }
  }
}

// ... and the transpose's planes: for each of the chunk's 4 columns, one
// 16-byte chunk of its row: the half's 4 rows
template <typename T>
__device__ __forceinline__ void write_trans(
    uint32_t big, uint32_t small, int gt,
    const uint4 (&x)[T::TPerThread][4]) {
#pragma unroll
  for (int t = 0; t < T::TPerThread; ++t) {
    int half, ch, g8;
    if (titem<T>(gt, t, half, ch, g8)) {
      constexpr int GP = T::KP / 8;   // groups of 8 keys per panel
      const uint32_t panel = (g8 / GP) * T::TPanel;
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const uint4 vals = make_uint4(lane_of(x[t][0], dd), lane_of(x[t][1], dd),
                                      lane_of(x[t][2], dd), lane_of(x[t][3], dd));
        uint4 b, s;
        split4(vals, b, s);
        const uint32_t off =
            swz<T::TW>(panel, 4 * ch + dd, 2 * (g8 % GP) + half);
        sts128(big + off, b);
        sts128(small + off, s);
      }
    }
  }
}

// a fixed 64-row tile split in place: big over the copy, small beside
template <typename T>
__device__ __forceinline__ void split_in_place(uint32_t big, uint32_t small,
                                               int gt) {
  for (int e = gt; e < T::Chunks; e += kGroup) {
    const uint32_t off = chunk_off<T>(e);
    uint4 b, s;
    split4(lds128(big + off), b, s);
    sts128(big + off, b);
    sts128(small + off, s);
  }
}

// d (64 x N) = a (64 fixed rows) . b^T (N rows), both K-major planes in
// shared memory, three passes per k-step (small.big, big.small, big.big),
// into d afresh; k-steps past D skipped
template <int DP, int N>
__device__ __forceinline__ void product3(float (&d)[N / 2], uint32_t ab,
                                         uint32_t as, uint32_t bb,
                                         uint32_t bs, int ksteps) {
  using A = Rows<DP, kRows>;
  using B = Rows<DP, N>;
  constexpr int W = A::W;
#pragma unroll
  for (int kst = 0; kst < DP / 8; ++kst) {
    if (kst < ksteps) {
      const uint32_t off = (kst * 8 % A::PC) * 4;
      const int pnl = kst * 8 / A::PC;
      const uint64_t a_b = wgmma_desc<W>(ab + pnl * A::Panel + off, 16, 8 * W);
      const uint64_t a_s = wgmma_desc<W>(as + pnl * A::Panel + off, 16, 8 * W);
      const uint64_t b_b = wgmma_desc<W>(bb + pnl * B::Panel + off, 16, 8 * W);
      const uint64_t b_s = wgmma_desc<W>(bs + pnl * B::Panel + off, 16, 8 * W);
      wgmma_tf32_ss<N>(d, a_s, b_b, kst > 0);
      wgmma_tf32_ss<N>(d, a_b, b_s, 1);
      wgmma_tf32_ss<N>(d, a_b, b_b, 1);
    }
  }
}

// an accumulator of 64 x BN f32 as the TF32 A fragments of its BN / 8
// k-steps (columns in the transposes' order), big and small
template <int BN>
__device__ __forceinline__ void to_planes(const float (&v)[BN / 2],
                                          uint32_t (&big)[BN / 8][4],
                                          uint32_t (&small)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    split_tf32(v[4 * kk], big[kk][0], small[kk][0]);
    split_tf32(v[4 * kk + 2], big[kk][1], small[kk][1]);
    split_tf32(v[4 * kk + 1], big[kk][2], small[kk][2]);
    split_tf32(v[4 * kk + 3], big[kk][3], small[kk][3]);
  }
}

// d (64 x DP) += a (registers, BN deep) . b (a transposed tile's planes:
// DP rows of BN), three passes per k-step
template <int DP, int BN>
__device__ __forceinline__ void product_t(float (&d)[DP / 2],
                                          const uint32_t (&big)[BN / 8][4],
                                          const uint32_t (&small)[BN / 8][4],
                                          uint32_t tb, uint32_t ts) {
  using T = Rows<DP, BN>;
  constexpr int SPP = T::KP / 8;   // k-steps per transposed panel
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    const uint32_t off = (kk / SPP) * T::TPanel + (kk % SPP) * 32;
    const uint64_t b_b = wgmma_desc<T::TW>(tb + off, 16, 8 * T::TW);
    const uint64_t b_s = wgmma_desc<T::TW>(ts + off, 16, 8 * T::TW);
    wgmma_tf32_rs<DP>(d, small[kk], b_b, 1);
    wgmma_tf32_rs<DP>(d, big[kk], b_s, 1);
    wgmma_tf32_rs<DP>(d, big[kk], b_b, 1);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_operand(r[e]);
}

template <int N>
__device__ __forceinline__ void fence_planes(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(p[kk][e]);
}

// rows of a 64 x DP accumulator (this thread's rows `row0` and `row0 + 8`
// of the tile) times `mul` into f32 rows of `out` below `rows`, columns
// below D (D % 4 == 0: d < D => d + 1 < D)
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           float* out, int64_t st, int row0,
                                           int rows, int D, int qd,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    if (t >= rows) continue;
    float* orow = out + int64_t(t) * st;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * qd;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

template <int DP, int BN, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_f32_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const float* __restrict__ bias, float* __restrict__ dq,
                        float* __restrict__ lse_ws,
                        float* __restrict__ delta_ws, int H, int Tq, int Tk,
                        int D, int tq_pad, int64_t dq_sb, int64_t dq_sh,
                        int64_t dq_st, float scale_log2, float scale) {
  using C = DqCfg<DP, BN>;
  using F = typename C::F;
  using R = typename C::R;
  constexpr int ST = C::Stages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * ST];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_b = base, q_s = base + F::Plane;
  const uint32_t do_b = base + 2 * F::Plane, do_s = base + 3 * F::Plane;
  const uint32_t kraw = base + 4 * F::Plane, vraw = kraw + R::Plane;
  // stage s: K big, K small, V big, V small, K^T big, K^T small
  auto plane = [&](int s, int p) {
    return vraw + R::Plane + (6 * s + p) * R::Plane;
  };
  float* bias_s = reinterpret_cast<float*>(
      smem_raw + (base - raw) + 4 * F::Plane + (2 + 6 * ST) * R::Plane);
  const uint32_t qfull = smem_u32(&bars[0]), rawfull = smem_u32(&bars[1]);
  auto ready = [&](int s) { return smem_u32(&bars[2 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[2 + ST + s]); };

  const int tid = threadIdx.x, wg = tid / kGroup, gt = tid % kGroup;
  const int lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int n = (Tk + BN - 1) / BN;

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(rawfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(ready(s), kGroup);   // every converting thread
      mbar_init(empty(s), kGroup);   // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_kv = [&](int j) {
    mbar_arrive_expect_tx(rawfull, 2 * R::Plane);
#pragma unroll
    for (int p = 0; p < R::NP; ++p) {
      tma_load_4d(kraw + p * R::Panel, &kmap, rawfull, p * R::PC, h, j * BN, b);
      tma_load_4d(vraw + p * R::Panel, &vmap, rawfull, p * R::PC, h, j * BN, b);
    }
  };

  if (wg == 0) {
    // converting warpgroup: the copies, then each key tile's planes, twice
    // (K^T's in the second sweep only)
    if (gt == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      prefetch_tensormap(&domap);
      mbar_arrive_expect_tx(qfull, 2 * F::Plane);
#pragma unroll
      for (int p = 0; p < F::NP; ++p) {
        tma_load_4d(q_b + p * F::Panel, &qmap, qfull, p * F::PC, h, q0, b);
        tma_load_4d(do_b + p * F::Panel, &domap, qfull, p * F::PC, h, q0, b);
      }
      load_kv(0);
    }
    const float* brow = kBias ? bias + int64_t(b) * Tk : nullptr;
    for (int i = 0; i < 2 * n; ++i) {
      const int s = i % ST, j = i % n;
      const bool second = i >= n;
      mbar_wait(rawfull, i & 1);
      uint4 kr[R::PerThread], vr[R::PerThread], kt[R::TPerThread][4];
      read_rows<R>(kraw, gt, kr);
      read_rows<R>(vraw, gt, vr);
      if (second) read_trans<R>(kraw, gt, kt);
      fence_proxy_async();   // the raw slots' reads, before TMA refills them
      named_barrier_sync(1, kGroup);
      if (gt == 0 && i + 1 < 2 * n) load_kv((i + 1) % n);
      if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
      write_rows<R>(plane(s, 0), plane(s, 1), gt, kr);
      write_rows<R>(plane(s, 2), plane(s, 3), gt, vr);
      if (second) write_trans<R>(plane(s, 4), plane(s, 5), gt, kt);
      float* bs = bias_s + s * BN;
      for (int kk = gt; kk < BN; kk += kGroup) {
        const int key = j * BN + kk;
        bs[kk] = key >= Tk ? -CUDART_INF_F : kBias ? brow[key] * kLog2e : 0.f;
      }
      fence_proxy_async();   // the planes, before wgmma reads them
      mbar_arrive(ready(s));
    }
    return;
  }

  const int w = (tid / 32) % 4, g = lane >> 2, qd = lane & 3;
  const int ksteps = (D + 7) / 8;
  mbar_wait(qfull, 0);
  split_in_place<F>(q_b, q_s, gt);
  split_in_place<F>(do_b, do_s, gt);
  fence_proxy_async();
  named_barrier_sync(2, kGroup);

  float S[BN / 2], dP[BN / 2];
  // S = Q.K^T and dP = dO.V^T of the tile in stage s, and the logits
  auto scores = [&](int s) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) S[e] = dP[e] = 0.f;
    wgmma_fence();
    product3<DP, BN>(S, q_b, q_s, plane(s, 0), plane(s, 1), ksteps);
    product3<DP, BN>(dP, do_b, do_s, plane(s, 2), plane(s, 3), ksteps);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(S);
    fence_all(dP);
    // the logits in the log2 domain: x = s * scale * log2(e) + bias
    const float* bs = bias_s + s * BN;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * c + 2 * qd);
      S[4 * c] = fmaf(S[4 * c], scale_log2, bb.x);
      S[4 * c + 1] = fmaf(S[4 * c + 1], scale_log2, bb.y);
      S[4 * c + 2] = fmaf(S[4 * c + 2], scale_log2, bb.x);
      S[4 * c + 3] = fmaf(S[4 * c + 3], scale_log2, bb.y);
    }
  };

  // sweep 1: this thread's rows g and g + 8 of its warp's 16: the running
  // max, its part of the row's sum and of u
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f},
        u[2] = {0.f, 0.f};
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    mbar_wait(ready(s), (i / ST) & 1);
    scores(s);
    mbar_arrive(empty(s));
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      mx[0] = fmaxf(mx[0], fmaxf(S[4 * c], S[4 * c + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(S[4 * c + 2], S[4 * c + 3]));
    }
    float ref[2], sum[2] = {0.f, 0.f}, usum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(mx[r], m[r]);
      ref[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r];
      const float alpha = ex2_approx(m[r] - ref[r]);
      l[r] *= alpha;
      u[r] *= alpha;
      m[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e >> 1) & 1;
      const float p = ex2_approx(S[e] - ref[r]);
      sum[r] += p;
      usum[r] = fmaf(p, dP[e], usum[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += sum[r];
      u[r] += usum[r];
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    u[r] += __shfl_xor_sync(0xffffffffu, u[r], 1);
    u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
    lse[r] = m[r] == -CUDART_INF_F ? CUDART_INF_F : m[r] + log2f(l[r]);
    delta[r] = m[r] == -CUDART_INF_F ? 0.f : u[r] / l[r];
    const int t = q0 + 16 * w + g + 8 * r;
    if (qd == 0) {
      const int64_t at = int64_t(bh) * tq_pad + t;
      lse_ws[at] = t < Tq ? lse[r] : CUDART_INF_F;
      delta_ws[at] = t < Tq ? delta[r] : 0.f;
    }
  }

  // sweep 2: dS and dQ += dS . K
  float dQ[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dQ[e] = 0.f;
  uint32_t big[BN / 8][4], small[BN / 8][4];
  for (int jj = 0; jj < n; ++jj) {
    const int i = n + jj, s = i % ST;
    mbar_wait(ready(s), (i / ST) & 1);
    scores(s);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e >> 1) & 1;
      S[e] = ex2_approx(S[e] - lse[r]) * (dP[e] - delta[r]);   // dS
    }
    to_planes<BN>(S, big, small);
    wgmma_fence();
    product_t<DP, BN>(dQ, big, small, plane(s, 4), plane(s, 5));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dQ);
    fence_planes(big);
    fence_planes(small);
    mbar_arrive(empty(s));
  }
  store_rows<DP>(dQ, dq + int64_t(b) * dq_sb + int64_t(h) * dq_sh, dq_st,
                 q0 + 16 * w + g, Tq, D, qd, scale);
}

template <int DP, int BN, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_f32_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ bias,
                          const float* __restrict__ lse_ws,
                          const float* __restrict__ delta_ws,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Tk, int D, int tq_pad, int64_t dk_sb,
                          int64_t dk_sh, int64_t dk_st, int64_t dv_sb,
                          int64_t dv_sh, int64_t dv_st, float scale_log2,
                          float scale) {
  using C = DkdvCfg<DP, BN>;
  using F = typename C::F;
  using R = typename C::R;
  constexpr int ST = C::Stages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * ST];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_b = base, k_s = base + F::Plane;
  const uint32_t v_b = base + 2 * F::Plane, v_s = base + 3 * F::Plane;
  const uint32_t qraw = base + 4 * F::Plane, doraw = qraw + R::Plane;
  // stage s: Q, dO, Q^T, dO^T, each big then small
  auto plane = [&](int s, int p) {
    return doraw + R::Plane + (8 * s + p) * R::Plane;
  };
  // per stage: the query tile's lse, then its Delta
  float* rows_s = reinterpret_cast<float*>(
      smem_raw + (base - raw) + 4 * F::Plane + (2 + 8 * ST) * R::Plane);
  const uint32_t kvfull = smem_u32(&bars[0]), rawfull = smem_u32(&bars[1]);
  auto ready = [&](int s) { return smem_u32(&bars[2 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[2 + ST + s]); };

  const int tid = threadIdx.x, wg = tid / kGroup, gt = tid % kGroup;
  const int lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int n = tq_pad / BN;

  if (tid == 0) {
    mbar_init(kvfull, 1);
    mbar_init(rawfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(ready(s), kGroup);
      mbar_init(empty(s), kGroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto load_qdo = [&](int i) {
    mbar_arrive_expect_tx(rawfull, 2 * R::Plane);
#pragma unroll
    for (int p = 0; p < R::NP; ++p) {
      tma_load_4d(qraw + p * R::Panel, &qmap, rawfull, p * R::PC, h, i * BN, b);
      tma_load_4d(doraw + p * R::Panel, &domap, rawfull, p * R::PC, h, i * BN,
                  b);
    }
  };

  if (wg == 0) {
    // converting warpgroup: K and V, then every query tile's planes, lse
    // and Delta
    if (gt == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      prefetch_tensormap(&domap);
      mbar_arrive_expect_tx(kvfull, 2 * F::Plane);
#pragma unroll
      for (int p = 0; p < F::NP; ++p) {
        tma_load_4d(k_b + p * F::Panel, &kmap, kvfull, p * F::PC, h, k0, b);
        tma_load_4d(v_b + p * F::Panel, &vmap, kvfull, p * F::PC, h, k0, b);
      }
      load_qdo(0);
    }
    const int64_t row_at = int64_t(bh) * tq_pad;
    for (int i = 0; i < n; ++i) {
      const int s = i % ST;
      mbar_wait(rawfull, i & 1);
      uint4 qr[R::PerThread], dr[R::PerThread];
      uint4 qt[R::TPerThread][4], dt[R::TPerThread][4];
      read_rows<R>(qraw, gt, qr);
      read_rows<R>(doraw, gt, dr);
      read_trans<R>(qraw, gt, qt);
      read_trans<R>(doraw, gt, dt);
      fence_proxy_async();
      named_barrier_sync(1, kGroup);
      if (gt == 0 && i + 1 < n) load_qdo(i + 1);
      if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
      write_rows<R>(plane(s, 0), plane(s, 1), gt, qr);
      write_rows<R>(plane(s, 2), plane(s, 3), gt, dr);
      write_trans<R>(plane(s, 4), plane(s, 5), gt, qt);
      write_trans<R>(plane(s, 6), plane(s, 7), gt, dt);
      float* rs = rows_s + s * 2 * BN;
      for (int r = gt; r < BN; r += kGroup) {
        rs[r] = lse_ws[row_at + i * BN + r];
        rs[BN + r] = delta_ws[row_at + i * BN + r];
      }
      fence_proxy_async();
      mbar_arrive(ready(s));
    }
    return;
  }

  const int w = (tid / 32) % 4, g = lane >> 2, qd = lane & 3;
  const int ksteps = (D + 7) / 8;
  // this thread's keys k0 + 16 w + g and + 8: their bias (log2 domain)
  float kb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * w + g + 8 * r;
    kb[r] = key >= Tk ? -CUDART_INF_F
            : kBias   ? bias[int64_t(b) * Tk + key] * kLog2e
                      : 0.f;
  }
  mbar_wait(kvfull, 0);
  split_in_place<F>(k_b, k_s, gt);
  split_in_place<F>(v_b, v_s, gt);
  fence_proxy_async();
  named_barrier_sync(2, kGroup);

  float dK[DP / 2], dV[DP / 2], S[BN / 2], dP[BN / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dK[e] = dV[e] = 0.f;
  uint32_t big[BN / 8][4], small[BN / 8][4];
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    mbar_wait(ready(s), (i / ST) & 1);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) S[e] = dP[e] = 0.f;
    wgmma_fence();
    product3<DP, BN>(S, k_b, k_s, plane(s, 0), plane(s, 1), ksteps);    // S^T
    product3<DP, BN>(dP, v_b, v_s, plane(s, 2), plane(s, 3), ksteps);   // dP^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(S);
    fence_all(dP);
    const float* rs = rows_s + s * 2 * BN;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {   // queries 8c + 2qd, + 1
      const float2 ls = *reinterpret_cast<const float2*>(rs + 8 * c + 2 * qd);
      const float2 dl =
          *reinterpret_cast<const float2*>(rs + BN + 8 * c + 2 * qd);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * c + r;
        const float p = ex2_approx(fmaf(S[e], scale_log2, kb[r >> 1]) -
                                   ((r & 1) ? ls.y : ls.x));
        S[e] = p;
        dP[e] = p * (dP[e] - ((r & 1) ? dl.y : dl.x));   // dS^T
      }
    }
    to_planes<BN>(S, big, small);
    wgmma_fence();
    product_t<DP, BN>(dV, big, small, plane(s, 6), plane(s, 7));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dV);
    fence_planes(big);
    fence_planes(small);
    to_planes<BN>(dP, big, small);
    wgmma_fence();
    product_t<DP, BN>(dK, big, small, plane(s, 4), plane(s, 5));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dK);
    fence_planes(big);
    fence_planes(small);
    mbar_arrive(empty(s));
  }
  const int row0 = k0 + 16 * w + g;
  store_rows<DP>(dK, dk + int64_t(b) * dk_sb + int64_t(h) * dk_sh, dk_st,
                 row0, Tk, D, qd, scale);
  store_rows<DP>(dV, dv + int64_t(b) * dv_sb + int64_t(h) * dv_sh, dv_st,
                 row0, Tk, D, qd, 1.f);
}

// one operand's f32 tensor map: (D, H, T, B) with element strides (sh, st,
// sb), a box of PC columns x `rows` rows of one head, swizzled as the
// tiles (64 bytes at PC = 16, else 128)
int encode_map(CUtensorMap* map, const void* p, int B, int H, int T, int D,
               int64_t sb, int64_t sh, int64_t st, int pc, int rows) {
  const int64_t outer[3][2] = {{sh, H}, {st, T}, {sb, B}};
  uint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of one element is never stepped over: any multiple of
    // 16 bytes will do for its stride
    const uint64_t v = uint64_t(outer[i][0]) * 4;
    strides[i] = outer[i][1] > 1 || (v > 0 && v % 16 == 0) ? v : 16;
  }
  const uint64_t dims[4] = {uint64_t(D), uint64_t(H), uint64_t(T),
                            uint64_t(B)};
  const uint32_t box[4] = {uint32_t(pc), 1, uint32_t(rows), 1};
  return encode_f32_map(map, p, 4, dims, strides, box,
                        pc == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Call {
  const void *q, *k, *v, *dout;
  const float* bias;
  void *dq, *dk, *dv;
  float* ws;
  int B, H, Tq, Tk, D;
  const int64_t* s;
  float scale;
  cudaStream_t stream;
};

template <int DP, int BN, bool kBias>
int launch(const Call& c) {
  using CQ = DqCfg<DP, BN>;
  using CK = DkdvCfg<DP, BN>;
  constexpr int PC = Rows<DP, kRows>::PC;
  const int64_t* s = c.s;
  // dq: Q, dO in 64-row boxes, K, V in BN-row boxes; dkdv the other way
  CUtensorMap q64, k64, v64, do64, qbn, kbn, vbn, dobn;
  int r = encode_map(&q64, c.q, c.B, c.H, c.Tq, c.D, s[0], s[1], s[2], PC,
                     kRows);
  if (r == 0)
    r = encode_map(&qbn, c.q, c.B, c.H, c.Tq, c.D, s[0], s[1], s[2], PC, BN);
  if (r == 0)
    r = encode_map(&k64, c.k, c.B, c.H, c.Tk, c.D, s[3], s[4], s[5], PC,
                   kRows);
  if (r == 0)
    r = encode_map(&kbn, c.k, c.B, c.H, c.Tk, c.D, s[3], s[4], s[5], PC, BN);
  if (r == 0)
    r = encode_map(&v64, c.v, c.B, c.H, c.Tk, c.D, s[6], s[7], s[8], PC,
                   kRows);
  if (r == 0)
    r = encode_map(&vbn, c.v, c.B, c.H, c.Tk, c.D, s[6], s[7], s[8], PC, BN);
  if (r == 0)
    r = encode_map(&do64, c.dout, c.B, c.H, c.Tq, c.D, s[9], s[10], s[11],
                   PC, kRows);
  if (r == 0)
    r = encode_map(&dobn, c.dout, c.B, c.H, c.Tq, c.D, s[9], s[10], s[11],
                   PC, BN);
  if (r != 0) return r;
  static bool a_set[kMaxDevices] = {}, b_set[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(flash_bwd_f32_dq_kernel<DP, BN, kBias>,
                                       CQ::SmemBytes, a_set);
  if (err == cudaSuccess)
    err = allow_dynamic_smem(flash_bwd_f32_dkdv_kernel<DP, BN, kBias>,
                             CK::SmemBytes, b_set);
  if (err != cudaSuccess) return int(err);
  const int tq_pad = (c.Tq + kRows - 1) / kRows * kRows;
  const int64_t rows = int64_t(c.B) * c.H * tq_pad;
  float* lse = c.ws;
  float* delta = c.ws + rows;
  const float sl2 = c.scale * kLog2e;
  flash_bwd_f32_dq_kernel<DP, BN, kBias>
      <<<dim3(tq_pad / kRows, c.B * c.H), kThreads, CQ::SmemBytes,
         c.stream>>>(q64, kbn, vbn, do64, c.bias, static_cast<float*>(c.dq),
                     lse, delta, c.H, c.Tq, c.Tk, c.D, tq_pad, s[12], s[13],
                     s[14], sl2, c.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_bwd_f32_dkdv_kernel<DP, BN, kBias>
      <<<dim3((c.Tk + kRows - 1) / kRows, c.B * c.H), kThreads,
         CK::SmemBytes, c.stream>>>(
          qbn, k64, v64, dobn, c.bias, lse, delta, static_cast<float*>(c.dk),
          static_cast<float*>(c.dv), c.H, c.Tk, c.D, tq_pad, s[15], s[16],
          s[17], s[18], s[19], s[20], sl2, c.scale);
  return int(cudaGetLastError());
}

template <int DP, int BN>
int launch_dp(const Call& c) {
  return c.bias ? launch<DP, BN, true>(c) : launch<DP, BN, false>(c);
}

}  // namespace
}  // namespace ns2vc

// f32 q, k, v, dout (the gradient of o) as (B, H, T, D) views by element
// strides (batch, head, seq) with unit stride on D; bias (B, Tk) f32
// contiguous or null; dq, dk, dv f32 (B, H, T, D) views by their strides
// (rows 8-byte aligned), written whole; scale the forward's. The 21
// strides: q, k, v, dout, dq, dk, dv, three each. The caller guarantees 1
// <= D <= 128 with D % 4 == 0, Tq, Tk >= 1, B*H <= 65535, q, k, v, dout
// 16-byte aligned with strides of whole 16-byte chunks (TMA's rule); ws:
// f32 workspace of 2 * B * H * Tq_pad values, Tq_pad = Tq rounded up to
// 64 (each row's lse, then its Delta). Returns the CUDA error of its
// launches (0 on success), or a negative code from a tensor map (-1:
// libcuda's encoder was not found; -(1000 + r): it returned CUresult r).
extern "C" int ns2vc_flash_attention_f32_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, void* dq, void* dk, void* dv, void* ws, int B, int H,
    int Tq, int Tk, int D, int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
    int64_t v_st, int64_t do_sb, int64_t do_sh, int64_t do_st, int64_t dq_sb,
    int64_t dq_sh, int64_t dq_st, int64_t dk_sb, int64_t dk_sh, int64_t dk_st,
    int64_t dv_sb, int64_t dv_sh, int64_t dv_st, float scale, void* stream) {
  using namespace ns2vc;
  const int64_t s[21] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,  k_st,  v_sb,
                         v_sh,  v_st,  do_sb, do_sh, do_st, dq_sb, dq_sh,
                         dq_st, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st};
  const Call c{q,  k,  v,  dout, static_cast<const float*>(bias),
               dq, dk, dv, static_cast<float*>(ws), B, H, Tq, Tk, D, s,
               scale, static_cast<cudaStream_t>(stream)};
  if (D % 4 != 0 || D < 1) return int(cudaErrorInvalidValue);
  if (D <= 16) return launch_dp<16, 64>(c);
  if (D <= 32) return launch_dp<32, 64>(c);
  if (D <= 64) return launch_dp<64, 32>(c);
  if (D <= 128) return launch_dp<128, 16>(c);
  return int(cudaErrorInvalidValue);
}
