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
// 32, key bias), the f32 gradient checks (the UNet's heads at D = 16, 32,
// 48, 64 and the encoders' at 32) and the op registry's f32 layers (D =
// 128, and 99 on unaligned rows).
//
// What bounds it on the H100: operations. f32 accuracy takes three TF32
// passes per product (big.big + big.small + small.big of each operand's
// TF32 halves), five products of 2 B H Tq Tk D FLOPs: at the F0
// cross-attention 3 x 6.05 GFLOP over 494.7 TFLOP/s, 0.037 ms a call.
// tf32 wgmma reads shared operands K-major only, so three of the five
// products need an operand transposed (dQ = dS.K needs K^T, dV = P^T.dO
// dO^T and dK = dS^T.Q Q^T).
// Design, three kernels, no atomics:
//   - `convert` splits q, k, v and dO once per call into their TF32 big and
//     small planes in a workspace: rows (BH, T, DP), zeros past D, and for
//     q, k and dO also the transposes (BH, DP, T8), T8 = T rounded up to 8,
//     each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7, so that the
//     accumulator's (2t, 2t + 1) pair of dS or P is the A fragment's (t, t +
//     4) and goes from registers into the next product with no shuffle,
//     zeros past T. It reads any rows (element loads through the views'
//     strides), so rows TMA cannot take ("f32tc_pad") need no copies. A
//     tile kernel converts nothing: TMA brings each plane, swizzled, into
//     the panels wgmma reads (a 4-D map per operand over (column, row,
//     batch*head, plane)), and each block is one consumer warpgroup of 64
//     fixed rows beside one producer warp that keeps the copies in flight.
//     The streamed tiles come a chunk of the head dim at a time (32
//     columns, 16 at DP = 16: one swizzled panel) through one ring of
//     units, each one operand's chunk, rows or transpose, big and small:
//     the rows feed the tile's first products (S and dP, which sum over
//     the chunks), the transposes its last (which write that chunk's
//     columns of the gradients). So the fixed tile's four planes (128 KB
//     at DP = 128) leave room for 64-key tiles at every width (products of
//     N = 64, not the 16 that whole 128-wide streamed tiles would fit),
//     and the ring keeps many units in flight: the consumer releases a
//     unit once its products are done, up to kDepth units' products in
//     flight. Measured on an H100 (scripts/torch_k1_f32_bwd_variants.py,
//     PERF.md): the products set the pace (time falls with the TF32
//     passes; with no copies at all it barely moves), not the loads;
//     At DP = 128, where the fixed tile leaves room for one block an SM,
//     two consumer warpgroups share it, each over half of the block's
//     streamed tiles with half of the ring (a producer warpgroup; setmaxnreg
//     moves its registers to the consumers), their partials added in order
//     (consumer 0's, then 1's) before the cluster's merge: while one runs
//     its softmax the other's products keep the tensor cores busy;
//   - `dq`, one block per (64 query rows, batch*head) and key split: Q's
//     and dO's planes once; its key tiles twice. Sweep 1: S = Q.K^T and dP =
//     dO.V^T (three passes, small terms first, both operands in shared
//     memory), the logits in the log2 domain and per row, online, the max
//     m, l = sum 2^(x - m) and u = sum 2^(x - m) dP. Delta = u / l comes from
//     the kernel's own f32 P and dP, never from O: dS = P (dP - Delta)
//     cancels where dP ~ Delta, and a Delta that is not the same sum the
//     row's P and dP give would carry the difference into every element of
//     the row. Sweep 2: S and dP again, dS split into its TF32 planes in
//     registers, dQ's chunks += dS.K^T's chunk planes (A from registers);
//   - `dkdv`, one block per (64 keys, batch*head) and query split: K's and
//     V's planes once; per query tile S^T = K.Q^T and dP^T = V.dO^T (keys
//     along wgmma's M), the tile's lse and Delta from the workspace, P^T =
//     2^(x - lse), dS^T = P^T (dP^T - Delta), both split in registers;
//     per chunk dV += P^T.dO^T and dK += dS^T.Q^T, A from registers.
// Where the (rows x batch*head) grid falls short of the SMs the streamed
// sweep is split over a thread-block cluster of up to 8 (`plan_f32_
// backward` in ops/flash_attention.py, a pure function of the shape):
// rank r takes the streamed tiles [r n / c, (r + 1) n / c). dq's ranks
// merge their rows' (m, l, u) through distributed shared memory in rank
// order before sweep 2 (each rank computes the same lse and Delta), and
// the partial dQ (dq) or dK and dV (dkdv) of the ranks are summed in rank
// order, rank r storing rows [64 r / c, 64 (r + 1) / c).
// Per head width (`Shape`): dq's key tile, dkdv's query tile, the ring's
// slots, blocks per SM. ptxas's register and spill report per
// instantiation is in the build log.
// Every split rounds to TF32 to nearest, ties away from zero, with
// integer operations (as cvt.rna and as ops/fused_resnet.py::tf32_round),
// and every sum runs in an order fixed by the shapes (wgmma's within a
// product, the chunks and tiles in order, a row's four lanes by xor
// shuffles, the ranks in order), so two launches on one input give
// bitwise-equal outputs. A fully masked row (every key at -1e4) has a
// finite max and stays finite. Head dims: DP = 16 (64-byte swizzle), 32,
// 64 or 128 (128-byte); 48 takes 64, 100 takes 128 (the planes hold zeros
// past D, the products skip the k-steps past D, and the columns past D are
// not stored).
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;     // the fixed tile's rows: queries or keys
constexpr int kGroup = 128;   // threads of a warpgroup: the consumer
constexpr int kThreads = kGroup + 32;   // and the producer warp (NW = 1)
constexpr int kSmemLimit = 232448;
constexpr int kMaxSplits = 8;

// per head width: dq's key tile (BN) and dkdv's query tile (KBN), the
// slots of each kernel's ring (a slot holds one unit: a chunk of one
// streamed operand, its rows or its transpose, big and small), the blocks
// an SM holds, and the consumer warpgroups of a block (NW: each takes its
// share of the block's streamed tiles over the same fixed rows, with its
// own part of the ring; at NW = 2 the producer is a warpgroup and
// setmaxnreg moves registers to the consumers) (ops/flash_attention.py
// `F32_BWD_SHAPES` mirrors BN, KBN and Blocks)
template <int DP>
struct Shape;
template <>
struct Shape<16> {
  static constexpr int BN = 64, KBN = 32, DqSlots = 11, KvSlots = 22,
                       Blocks = 2;
  static constexpr int NW = 1;
};
template <>
struct Shape<32> {
  static constexpr int BN = 64, KBN = 32, DqSlots = 4, KvSlots = 9,
                       Blocks = 2;
  static constexpr int NW = 1;
};
template <>
struct Shape<64> {
  static constexpr int BN = 64, KBN = 32, DqSlots = 9, KvSlots = 19,
                       Blocks = 1;
  static constexpr int NW = 1;
};
template <>
struct Shape<128> {
  static constexpr int BN = 64, KBN = 32, DqSlots = 6, KvSlots = 12,
                       Blocks = 1;
  static constexpr int NW = 2;
};

// a tile of R rows of DP f32 in W-byte swizzled panels of PC columns (the
// TMA box's layout, rows along M or N and K contiguous: K-major; a chunk
// of the head dim is one panel), and the transpose of a chunk: PC rows of
// R keys in TW-byte swizzled sub-panels of KP keys (32 keys a 128-byte
// sub-panel, 16 keys one 64-byte sub-panel at R = 16)
template <int DP, int R>
struct Rows {
  static constexpr int W = DP < 32 ? 4 * DP : 128;
  static constexpr int PC = W / 4;                  // columns per panel
  static constexpr int NP = DP / PC;                // panels: chunks
  static constexpr int Panel = R * W;
  static constexpr int Plane = NP * Panel;
  static constexpr int TW = R >= 32 ? 128 : 4 * R;
  static constexpr int KP = TW / 4;                 // keys per sub-panel
  static constexpr int NTP = R / KP;                // sub-panels of a chunk
  static constexpr int TSub = PC * TW;
  static constexpr int TChunk = NTP * TSub;         // a chunk's transpose
  static_assert(Panel % 1024 == 0 && TSub % 1024 == 0, "atom alignment");
  static_assert(TChunk == Panel, "a chunk's rows and transpose alike");
  static_assert(R % KP == 0 && KP % 16 == 0,
                "whole sub-panels of the transpose");
};

// a block's threads: NW consumer warpgroups and a producer warp, or at NW
// > 1 a producer warpgroup (setmaxnreg works on whole warpgroups)
template <int DP>
constexpr int kThreadsOf = Shape<DP>::NW == 1 ? kThreads
                                              : (Shape<DP>::NW + 1) * kGroup;

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// shared memory of a tile kernel: the fixed tile's four planes, then the
// ring: `Slots` units of R streamed rows (one chunk of one operand, rows
// or transpose, big then small)
template <int DP, int R, int Slots>
struct Smem {
  using F = Rows<DP, kRows>;
  static constexpr int Unit = 2 * Rows<DP, R>::Panel;
  static constexpr int Bytes = 1024 + 4 * F::Plane + Slots * Unit;
  static_assert(Bytes + 2048 <= kSmemLimit, "shared memory of one block");
  static_assert(Shape<DP>::Blocks == 1 || 2 * (Bytes + 2048) <= 233472,
                "two blocks an SM");
};

template <int DP>
using DqSmem = Smem<DP, Shape<DP>::BN, Shape<DP>::DqSlots>;
template <int DP>
using KvSmem = Smem<DP, Shape<DP>::KBN, Shape<DP>::KvSlots>;

// a ring of units in shared memory: a full and an empty barrier per slot;
// producer and consumer walk the same sequence of units
struct Ring {
  uint32_t slots, bars;   // first slot, first barrier (full, then empty)
  int n, unit;
  __device__ uint32_t slot(int u) const { return slots + (u % n) * unit; }
  __device__ uint32_t full(int u) const { return bars + 8 * (u % n); }
  __device__ uint32_t empty(int u) const { return bars + 8 * (n + u % n); }
  __device__ uint32_t parity(int u) const { return (u / n) & 1; }
};

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

// d (64 x N) += a (64 fixed rows) . b^T (N rows) over one chunk of the
// head dim: a's panel and b's, K-major planes in shared memory, three
// passes per k-step (small.big, big.small, big.big); k-steps at or past
// `ksteps` (past D) skipped
template <int DP, int N>
__device__ __forceinline__ void chunk3(float (&d)[N / 2], uint32_t ab,
                                       uint32_t as, uint32_t bb, uint32_t bs,
                                       int kst0, int ksteps) {
  constexpr int W = Rows<DP, N>::W, PC = Rows<DP, N>::PC;
#pragma unroll
  for (int k = 0; k < PC / 8; ++k) {
    if (kst0 + k < ksteps) {
      const uint64_t a_b = wgmma_desc<W>(ab + 32 * k, 16, 8 * W);
      const uint64_t a_s = wgmma_desc<W>(as + 32 * k, 16, 8 * W);
      const uint64_t b_b = wgmma_desc<W>(bb + 32 * k, 16, 8 * W);
      const uint64_t b_s = wgmma_desc<W>(bs + 32 * k, 16, 8 * W);
      wgmma_tf32_ss<N>(d, a_s, b_b, 1);
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

// d (64 x PC: one chunk's columns) += a (registers, R deep) . b (a chunk's
// transpose planes: PC rows of R), three passes per k-step
template <int DP, int R>
__device__ __forceinline__ void chunk_t(float (&dc)[Rows<DP, R>::PC / 2],
                                        const uint32_t (&big)[R / 8][4],
                                        const uint32_t (&small)[R / 8][4],
                                        uint32_t tb, uint32_t ts) {
  using T = Rows<DP, R>;
  constexpr int SPP = T::KP / 8;   // k-steps per sub-panel
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    const uint32_t off = (kk / SPP) * T::TSub + (kk % SPP) * 32;
    const uint64_t b_b = wgmma_desc<T::TW>(tb + off, 16, 8 * T::TW);
    const uint64_t b_s = wgmma_desc<T::TW>(ts + off, 16, 8 * T::TW);
    wgmma_tf32_rs<T::PC>(dc, small[kk], b_b, 1);
    wgmma_tf32_rs<T::PC>(dc, big[kk], b_s, 1);
    wgmma_tf32_rs<T::PC>(dc, big[kk], b_b, 1);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_operand(r[e]);
}

template <int NP, int N>
__device__ __forceinline__ void fence_chunks(float (&r)[NP][N]) {
#pragma unroll
  for (int c = 0; c < NP; ++c) fence_all(r[c]);
}

template <int N>
__device__ __forceinline__ void fence_planes(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(p[kk][e]);
}

// the split arrive and wait of the cluster barrier (the producer warp
// arrives, copies on, and waits later), every thread of the warp together
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one operand's planes: the row planes at `rows` (2, BH, T, DP) and the
// transposes at `trans` (2, BH, DP, T8) or null
struct Operand {
  const float* x;
  int64_t sb, sh, st;   // the view's element strides
  int T, T8;
  float* rows;
  float* trans;
};

// position p of a group of 8 in a transpose holds key perm(p) of the group
__device__ __forceinline__ int perm8(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

// the planes of 64 rows of one (operand, batch*head): blockIdx.z picks q,
// k, v or dO
template <int DP>
__global__ void __launch_bounds__(256)
flash_bwd_f32_convert_kernel(const Operand q, const Operand k, const Operand v,
                             const Operand dout, int H, int D, int BH) {
  __shared__ float tile[kRows][DP + 1];
  const Operand o = blockIdx.z == 0   ? q
                    : blockIdx.z == 1 ? k
                    : blockIdx.z == 2 ? v
                                      : dout;
  const int t0 = blockIdx.x * kRows, bh = blockIdx.y, tid = threadIdx.x;
  const int b = bh / H, h = bh % H;
  if (t0 >= (o.trans ? o.T8 : o.T)) return;
  const float* src = o.x + int64_t(b) * o.sb + int64_t(h) * o.sh;
  for (int e = tid; e < kRows * DP; e += 256) {
    const int r = e / DP, d = e % DP, t = t0 + r;
    tile[r][d] = t < o.T && d < D ? __ldg(src + int64_t(t) * o.st + d) : 0.f;
  }
  __syncthreads();
  const int64_t plane = int64_t(BH) * o.T * DP;
  for (int e = tid; e < kRows * DP / 4; e += 256) {
    const int r = e / (DP / 4), c = e % (DP / 4), t = t0 + r;
    if (t >= o.T) continue;
    uint4 big, small;
    split_tf32(tile[r][4 * c], big.x, small.x);
    split_tf32(tile[r][4 * c + 1], big.y, small.y);
    split_tf32(tile[r][4 * c + 2], big.z, small.z);
    split_tf32(tile[r][4 * c + 3], big.w, small.w);
    float* dst = o.rows + (int64_t(bh) * o.T + t) * DP + 4 * c;
    *reinterpret_cast<uint4*>(dst) = big;
    *reinterpret_cast<uint4*>(dst + plane) = small;
  }
  if (o.trans == nullptr) return;
  const int64_t tplane = int64_t(BH) * DP * o.T8;
  for (int e = tid; e < DP * (kRows / 4); e += 256) {
    const int d = e / (kRows / 4), p0 = 4 * (e % (kRows / 4));
    if (t0 + p0 >= o.T8) continue;
    uint32_t big[4], small[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + j;
      split_tf32(tile[(p & ~7) + perm8(p & 7)][d], big[j], small[j]);
    }
    float* dst = o.trans + (int64_t(bh) * DP + d) * o.T8 + t0 + p0;
    *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(dst + tplane) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// a 64 x DP accumulator as one accumulator of 64 x PC per chunk of the
// head dim: this thread's value (row r of its two, column pair j of DP / 8)
template <int DP>
using Acc = float[Rows<DP, kRows>::NP][Rows<DP, kRows>::PC / 2];

template <int DP>
__device__ __forceinline__ float acc_at(const Acc<DP>& acc, int j, int e) {
  constexpr int JP = Rows<DP, kRows>::PC / 8;   // column groups a chunk
  return acc[j / JP][4 * (j % JP) + e];
}

// rows of a 64 x DP accumulator (this thread's rows `row0` and `row0 + 8`
// of the tile) times `mul` into f32 rows of `out` below `rows`, columns
// below D (D % 4 == 0: d < D => d + 1 < D)
template <int DP>
__device__ __forceinline__ void store_rows(const Acc<DP>& acc, float* out,
                                           int64_t st, int row0, int rows,
                                           int D, int qd, float mul) {
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
            make_float2(acc_at<DP>(acc, j, 2 * i) * mul,
                        acc_at<DP>(acc, j, 2 * i + 1) * mul);
    }
  }
}

// a consumer's 64 x DP accumulator into a partial tile in shared memory
// (rows of DP + 4 floats)
template <int DP>
__device__ __forceinline__ void stash_rows(const Acc<DP>& acc, float* part,
                                           int row0, int qd) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<float2*>(part + (row0 + 8 * i) * (DP + 4) + 8 * j +
                                 2 * qd) =
          make_float2(acc_at<DP>(acc, j, 2 * i), acc_at<DP>(acc, j, 2 * i + 1));
}

// a partial tile in shared memory (rows of DP + 4 floats) added into a
// consumer's accumulator, after its own values
template <int DP>
__device__ __forceinline__ void add_rows(Acc<DP>& acc, const float* part,
                                         int row0, int qd) {
  constexpr int JP = Rows<DP, kRows>::PC / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          part + (row0 + 8 * i) * (DP + 4) + 8 * j + 2 * qd);
      acc[j / JP][4 * (j % JP) + 2 * i] += v.x;
      acc[j / JP][4 * (j % JP) + 2 * i + 1] += v.y;
    }
}

// rank `rank` of `splits`: rows [64 rank / splits, 64 (rank + 1) / splits)
// of the ranks' partial tiles at `part` (shared address), summed in rank
// order, times `mul`, into f32 rows of `out` below `rows`, columns below D;
// every thread of the block takes a share
template <int DP>
__device__ __forceinline__ void merge_rows(uint32_t part, int splits,
                                           int rank, float* out, int64_t st,
                                           int t0, int rows, int D, float mul) {
  const int rb = rank * kRows / splits, re = (rank + 1) * kRows / splits;
  for (int e = threadIdx.x; e < (re - rb) * (DP / 2); e += blockDim.x) {
    const int row = rb + e / (DP / 2), col = 2 * (e % (DP / 2));
    if (t0 + row >= rows || col >= D) continue;
    const uint32_t at = part + (row * (DP + 4) + col) * 4;
    float x = 0.f, y = 0.f;
    for (int r = 0; r < splits; ++r) {
      x += ld_cluster_f32(map_to_rank(at, r));
      y += ld_cluster_f32(map_to_rank(at + 4, r));
    }
    *reinterpret_cast<float2*>(out + int64_t(t0 + row) * st + col) =
        make_float2(x * mul, y * mul);
  }
}

// the producer's unit u: wait for its slot to be free, expect its bytes
__device__ __forceinline__ uint32_t ring_put(const Ring& r, int u) {
  if (u >= r.n) mbar_wait(r.empty(u), ((u / r.n) - 1) & 1);
  mbar_arrive_expect_tx(r.full(u), r.unit);
  return r.slot(u);
}

// a chunk's rows of one operand (big, small) into a slot: a box of PC
// columns x R rows per plane
template <int DP, int R>
__device__ __forceinline__ void put_rows(const Ring& r, int u,
                                         const CUtensorMap* map, int c,
                                         int row0, int bh) {
  using T = Rows<DP, R>;
  const uint32_t slot = ring_put(r, u);
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
    tma_load_4d(slot + pl * T::Panel, map, r.full(u), c * T::PC, row0, bh,
                pl);
}

// a chunk's transpose of one operand (big, small) into a slot: per plane
// NTP boxes of KP keys x PC rows
template <int DP, int R>
__device__ __forceinline__ void put_trans(const Ring& r, int u,
                                          const CUtensorMap* map, int c,
                                          int key0, int bh) {
  using T = Rows<DP, R>;
  const uint32_t slot = ring_put(r, u);
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int p = 0; p < T::NTP; ++p)
      tma_load_4d(slot + pl * T::TChunk + p * T::TSub, map, r.full(u),
                  key0 + p * T::KP, c * T::PC, bh, pl);
}

// the consumer's products in flight: up to kDepth units' groups of wgmma
// are issued ahead of the oldest one's completion, which releases its unit
// (so a consumer's part of a ring needs kDepth + 1 slots or more)
constexpr int kDepth = 1;

// the consumer's unit u: wait for it, run its products (fn, on its slot)
// and commit them; `held` units (the last ones taken) are still read by
// products in flight: past kDepth the oldest is waited for and released
template <typename Fn>
__device__ __forceinline__ void ring_take(const Ring& r, int& u, int& held,
                                          Fn&& fn) {
  mbar_wait(r.full(u), r.parity(u));
  wgmma_fence();
  fn(r.slot(u));
  wgmma_commit();
  ++u;
  if (++held > kDepth) {
    wgmma_wait<kDepth>();
    mbar_arrive(r.empty(u - held));
    --held;
  }
}

// every product in flight done: the held units released, oldest first
__device__ __forceinline__ void ring_drain(const Ring& r, int u, int& held) {
  wgmma_wait<0>();
  for (; held > 0; --held) mbar_arrive(r.empty(u - held));
}

template <int DP, bool kBias>
__global__ void __launch_bounds__(kThreadsOf<DP>, Shape<DP>::Blocks)
flash_bwd_f32_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap ktmap,
                        const float* __restrict__ bias, float* __restrict__ dq,
                        float* __restrict__ lse_ws,
                        float* __restrict__ delta_ws, int H, int Tq, int Tk,
                        int D, int tq_pad, int64_t dq_sb, int64_t dq_sh,
                        int64_t dq_st, float scale_log2, float scale,
                        int splits) {
  constexpr int BN = Shape<DP>::BN, NS = Shape<DP>::DqSlots;
  constexpr int NW = Shape<DP>::NW, NSW = NS / NW;   // a consumer's slots
  static_assert(NSW > kDepth, "a consumer's ring holds its products' units");
  using M = DqSmem<DP>;
  using F = Rows<DP, kRows>;
  using R = Rows<DP, BN>;
  constexpr int NP = F::NP, PC = F::PC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NS];
  __shared__ float mlu[3][kRows];   // this rank's rows' m, l, u

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_b = base, q_s = base + F::Plane;
  const uint32_t do_b = base + 2 * F::Plane, do_s = base + 3 * F::Plane;
  // consumer cw's part of the ring: its units, per key tile: each chunk's
  // K rows and V rows, then in sweep 2 each chunk's K^T
  const uint32_t rows0 = base + 4 * F::Plane;
  auto ring_of = [&](int cw) {
    return Ring{rows0 + cw * NSW * M::Unit, smem_u32(&bars[1 + 2 * NSW * cw]),
                NSW, M::Unit};
  };
  const uint32_t qfull = smem_u32(&bars[0]);

  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = blockIdx.x % splits;
  const int q0 = (blockIdx.x / splits) * kRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n = (Tk + BN - 1) / BN;
  const int j_lo = rank * n / splits, own = (rank + 1) * n / splits - j_lo;
  // consumer cw's key tiles: [j_lo + cw own / NW, j_lo + (cw + 1) own / NW)
  auto lo_of = [&](int cw) { return j_lo + cw * own / NW; };
  auto own_of = [&](int cw) { return (cw + 1) * own / NW - cw * own / NW; };

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int cw = 0; cw < NW; ++cw)
      for (int s = 0; s < NSW; ++s) {
        mbar_init(ring_of(cw).full(s), 1);
        mbar_init(ring_of(cw).empty(s), kGroup);
      }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NW * kGroup) {
    // the producer: Q's and dO's planes, then per key tile of both sweeps
    // each chunk's K and V rows, and in sweep 2 each chunk's K^T, the
    // consumers' tiles in turn
    if constexpr (NW > 1) setmaxnreg_dec<40>();
    const bool issuer = tid == NW * kGroup;
    int u[NW] = {};   // each ring's units, in its consumer's order
    auto tiles = [&](bool second) {
      for (int i = 0; i < (own + NW - 1) / NW; ++i)
#pragma unroll
        for (int cw = 0; cw < NW; ++cw) {
          if (i >= own_of(cw)) continue;
          const Ring ring = ring_of(cw);
          const int j = lo_of(cw) + i;
#pragma unroll 1
          for (int c = 0; c < NP; ++c) {
            put_rows<DP, BN>(ring, u[cw]++, &kmap, c, j * BN, bh);
            put_rows<DP, BN>(ring, u[cw]++, &vmap, c, j * BN, bh);
          }
          if (!second) continue;   // sweep 1 reads no transposes
#pragma unroll 1
          for (int c = 0; c < NP; ++c)
            put_trans<DP, BN>(ring, u[cw]++, &ktmap, c, j * BN, bh);
        }
    };
    if (issuer) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&domap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      prefetch_tensormap(&ktmap);
      mbar_arrive_expect_tx(qfull, 4 * F::Plane);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(q_b + pl * F::Plane + p * F::Panel, &qmap, qfull,
                      p * PC, q0, bh, pl);
          tma_load_4d(do_b + pl * F::Plane + p * F::Panel, &domap, qfull,
                      p * PC, q0, bh, pl);
        }
      tiles(false);
    }
    __syncwarp();
    if (splits > 1) cluster_arrive();   // the sweep-1 merge
    if (issuer) tiles(true);
    __syncwarp();
    if (splits > 1) {
      cluster_wait();
      cluster_arrive();   // the consumers' partial dQ
      cluster_wait();
      merge_rows<DP>(rows0, splits, rank,
                     dq + int64_t(b) * dq_sb + int64_t(h) * dq_sh, dq_st, q0,
                     Tq, D, scale);
      cluster_arrive();   // the peers have read this block's partial
      cluster_wait();
    }
    return;
  }

  if constexpr (NW > 1) setmaxnreg_inc<232>();
  const int cw = tid / kGroup, w = (tid / 32) % 4, g = lane >> 2, qd = lane & 3;
  const int ksteps = (D + 7) / 8;
  const float* brow = kBias ? bias + int64_t(b) * Tk : nullptr;
  const Ring ring = ring_of(cw);
  const int my_lo = lo_of(cw), my_own = own_of(cw);
  int uc = 0, held = 0;
  mbar_wait(qfull, 0);

  float S[BN / 2], dP[BN / 2];
  // S = Q.K^T and dP = dO.V^T of key tile j over the head dim's chunks,
  // and the logits
  auto scores = [&](int j) {
    float2 kb[BN / 8];   // keys 8c + 2qd, + 1: their bias (log2 domain)
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int key = j * BN + 8 * c + 2 * qd;
      kb[c].x = key >= Tk ? -CUDART_INF_F : kBias ? __ldg(brow + key) * kLog2e : 0.f;
      kb[c].y = key + 1 >= Tk ? -CUDART_INF_F
                : kBias       ? __ldg(brow + key + 1) * kLog2e
                              : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) S[e] = dP[e] = 0.f;
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      ring_take(ring, uc, held, [&](uint32_t slot) {
        chunk3<DP, BN>(S, q_b + c * F::Panel, q_s + c * F::Panel, slot,
                       slot + R::Panel, c * (PC / 8), ksteps);
      });
      ring_take(ring, uc, held, [&](uint32_t slot) {
        chunk3<DP, BN>(dP, do_b + c * F::Panel, do_s + c * F::Panel, slot,
                       slot + R::Panel, c * (PC / 8), ksteps);
      });
    }
    ring_drain(ring, uc, held);
    fence_all(S);
    fence_all(dP);
    // the logits in the log2 domain: x = s * scale * log2(e) + bias
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      S[4 * c] = fmaf(S[4 * c], scale_log2, kb[c].x);
      S[4 * c + 1] = fmaf(S[4 * c + 1], scale_log2, kb[c].y);
      S[4 * c + 2] = fmaf(S[4 * c + 2], scale_log2, kb[c].x);
      S[4 * c + 3] = fmaf(S[4 * c + 3], scale_log2, kb[c].y);
    }
  };

  // sweep 1: this thread's rows g and g + 8 of its warp's 16: the running
  // max, its part of the row's sum and of u
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f},
        u[2] = {0.f, 0.f};
  for (int i = 0; i < my_own; ++i) {
    scores(my_lo + i);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    u[r] += __shfl_xor_sync(0xffffffffu, u[r], 1);
    u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
  }
  const int row0 = 16 * w + g;
  if constexpr (NW > 1) {
    // the consumers' (m, l, u) of each row, rescaled to their max, in
    // order: consumer 1's through `mlu`, then the block's back to it
    if (cw == 1 && qd == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mlu[0][row0 + 8 * r] = m[r];
        mlu[1][row0 + 8 * r] = l[r];
        mlu[2][row0 + 8 * r] = u[r];
      }
    }
    named_barrier_sync(1, NW * kGroup);
    if (cw == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float m1 = mlu[0][row], mx = fmaxf(m[r], m1);
        const float ref = mx == -CUDART_INF_F ? 0.f : mx;
        const float a0 = ex2_approx(m[r] - ref), a1 = ex2_approx(m1 - ref);
        l[r] = fmaf(mlu[1][row], a1, l[r] * a0);
        u[r] = fmaf(mlu[2][row], a1, u[r] * a0);
        m[r] = mx;
      }
    }
    named_barrier_sync(1, NW * kGroup);
    if (cw == 0 && qd == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mlu[0][row0 + 8 * r] = m[r];
        mlu[1][row0 + 8 * r] = l[r];
        mlu[2][row0 + 8 * r] = u[r];
      }
    }
    named_barrier_sync(1, NW * kGroup);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = mlu[0][row0 + 8 * r];
      l[r] = mlu[1][row0 + 8 * r];
      u[r] = mlu[2][row0 + 8 * r];
    }
  }
  if (splits > 1) {
    // the ranks' (m, l, u) of each row, rescaled to their max, in rank order
    if (qd == 0 && cw == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mlu[0][row0 + 8 * r] = m[r];
        mlu[1][row0 + 8 * r] = l[r];
        mlu[2][row0 + 8 * r] = u[r];
      }
    }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      float mr[kMaxSplits], mx = -CUDART_INF_F;
      for (int k = 0; k < splits; ++k) {
        mr[k] = ld_cluster_f32(map_to_rank(smem_u32(&mlu[0][row]), k));
        mx = fmaxf(mx, mr[k]);
      }
      const float ref = mx == -CUDART_INF_F ? 0.f : mx;
      float ls = 0.f, us = 0.f;
      for (int k = 0; k < splits; ++k) {
        const float a = ex2_approx(mr[k] - ref);
        ls = fmaf(ld_cluster_f32(map_to_rank(smem_u32(&mlu[1][row]), k)), a, ls);
        us = fmaf(ld_cluster_f32(map_to_rank(smem_u32(&mlu[2][row]), k)), a, us);
      }
      m[r] = mx;
      l[r] = ls;
      u[r] = us;
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = m[r] == -CUDART_INF_F ? CUDART_INF_F : m[r] + log2f(l[r]);
    delta[r] = m[r] == -CUDART_INF_F ? 0.f : u[r] / l[r];
    const int t = q0 + row0 + 8 * r;
    if (qd == 0 && rank == 0 && cw == 0) {
      const int64_t at = int64_t(bh) * tq_pad + t;
      lse_ws[at] = t < Tq ? lse[r] : CUDART_INF_F;
      delta_ws[at] = t < Tq ? delta[r] : 0.f;
    }
  }

  // sweep 2: dS, and per chunk dQ[:, chunk] += dS . K[:, chunk]
  Acc<DP> dQ;
#pragma unroll
  for (int c = 0; c < NP; ++c)
#pragma unroll
    for (int e = 0; e < PC / 2; ++e) dQ[c][e] = 0.f;
  uint32_t big[BN / 8][4], small[BN / 8][4];
  for (int jj = 0; jj < my_own; ++jj) {
    scores(my_lo + jj);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e >> 1) & 1;
      S[e] = ex2_approx(S[e] - lse[r]) * (dP[e] - delta[r]);   // dS
    }
    to_planes<BN>(S, big, small);
#pragma unroll
    for (int c = 0; c < NP; ++c)
      ring_take(ring, uc, held, [&](uint32_t slot) {
        chunk_t<DP, BN>(dQ[c], big, small, slot, slot + R::TChunk);
      });
    ring_drain(ring, uc, held);
    fence_chunks(dQ);
    fence_planes(big);
    fence_planes(small);
  }
  float* dqb = dq + int64_t(b) * dq_sb + int64_t(h) * dq_sh;
  float* ringf = reinterpret_cast<float*>(smem_raw + (rows0 - raw));
  if constexpr (NW > 1) {
    // consumer 1's partial dQ into consumer 0's, through the ring (every
    // copy has landed and every product has read its operands)
    named_barrier_sync(1, NW * kGroup);
    if (cw == 1) stash_rows<DP>(dQ, ringf, row0, qd);
    named_barrier_sync(1, NW * kGroup);
    if (cw == 0) add_rows<DP>(dQ, ringf, row0, qd);
  }
  if (splits == 1) {
    if (cw == 0) store_rows<DP>(dQ, dqb, dq_st, q0 + row0, Tq, D, qd, scale);
    return;
  }
  // the ranks' partial dQ, summed in rank order (the ring is free: every
  // copy has landed and every product has read its operands)
  named_barrier_sync(1, NW * kGroup);
  if (cw == 0) stash_rows<DP>(dQ, ringf, row0, qd);
  cluster_arrive();
  cluster_wait();
  merge_rows<DP>(rows0, splits, rank, dqb, dq_st, q0, Tq, D, scale);
  cluster_arrive();
  cluster_wait();
}

template <int DP, bool kBias>
__global__ void __launch_bounds__(kThreadsOf<DP>, Shape<DP>::Blocks)
flash_bwd_f32_dkdv_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap qtmap,
                          const __grid_constant__ CUtensorMap dotmap,
                          const float* __restrict__ bias,
                          const float* __restrict__ lse_ws,
                          const float* __restrict__ delta_ws,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Tq, int Tk, int D, int tq_pad,
                          int64_t dk_sb, int64_t dk_sh, int64_t dk_st,
                          int64_t dv_sb, int64_t dv_sh, int64_t dv_st,
                          float scale_log2, float scale, int splits) {
  constexpr int BN = Shape<DP>::KBN, NS = Shape<DP>::KvSlots;
  constexpr int NW = Shape<DP>::NW, NSW = NS / NW;   // a consumer's slots
  static_assert(NSW > kDepth, "a consumer's ring holds its products' units");
  using M = KvSmem<DP>;
  using F = Rows<DP, kRows>;
  using R = Rows<DP, BN>;
  constexpr int NP = F::NP, PC = F::PC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NS];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_b = base, k_s = base + F::Plane;
  const uint32_t v_b = base + 2 * F::Plane, v_s = base + 3 * F::Plane;
  // consumer cw's part of the ring: its units, per query tile: each
  // chunk's Q rows and dO rows, then each chunk's dO^T and Q^T
  const uint32_t rows0 = base + 4 * F::Plane;
  auto ring_of = [&](int cw) {
    return Ring{rows0 + cw * NSW * M::Unit, smem_u32(&bars[1 + 2 * NSW * cw]),
                NSW, M::Unit};
  };
  const uint32_t kvfull = smem_u32(&bars[0]);

  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = blockIdx.x % splits;
  const int k0 = (blockIdx.x / splits) * kRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n = (Tq + BN - 1) / BN;
  const int i_lo = rank * n / splits, own = (rank + 1) * n / splits - i_lo;
  // consumer cw's query tiles: [i_lo + cw own / NW, i_lo + (cw + 1) own / NW)
  auto lo_of = [&](int cw) { return i_lo + cw * own / NW; };
  auto own_of = [&](int cw) { return (cw + 1) * own / NW - cw * own / NW; };
  float* dkb = dk + int64_t(b) * dk_sb + int64_t(h) * dk_sh;
  float* dvb = dv + int64_t(b) * dv_sb + int64_t(h) * dv_sh;
  const uint32_t part_k = base, part_v = base + kRows * (DP + 4) * 4;

  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int cw = 0; cw < NW; ++cw)
      for (int s = 0; s < NSW; ++s) {
        mbar_init(ring_of(cw).full(s), 1);
        mbar_init(ring_of(cw).empty(s), kGroup);
      }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NW * kGroup) {
    // the producer: K's and V's planes, then per query tile each chunk's Q
    // and dO rows and each chunk's Q^T and dO^T, the consumers' tiles in
    // turn
    if constexpr (NW > 1) setmaxnreg_dec<40>();
    if (tid == NW * kGroup) {
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&domap);
      prefetch_tensormap(&qtmap);
      prefetch_tensormap(&dotmap);
      mbar_arrive_expect_tx(kvfull, 4 * F::Plane);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(k_b + pl * F::Plane + p * F::Panel, &kmap, kvfull,
                      p * PC, k0, bh, pl);
          tma_load_4d(v_b + pl * F::Plane + p * F::Panel, &vmap, kvfull,
                      p * PC, k0, bh, pl);
        }
      int u[NW] = {};   // each ring's units, in its consumer's order
      for (int i = 0; i < (own + NW - 1) / NW; ++i)
#pragma unroll
        for (int cw = 0; cw < NW; ++cw) {
          if (i >= own_of(cw)) continue;
          const Ring ring = ring_of(cw);
          const int t0 = (lo_of(cw) + i) * BN;
#pragma unroll 1
          for (int c = 0; c < NP; ++c) {
            put_rows<DP, BN>(ring, u[cw]++, &qmap, c, t0, bh);
            put_rows<DP, BN>(ring, u[cw]++, &domap, c, t0, bh);
          }
#pragma unroll 1
          for (int c = 0; c < NP; ++c) {
            put_trans<DP, BN>(ring, u[cw]++, &dotmap, c, t0, bh);
            put_trans<DP, BN>(ring, u[cw]++, &qtmap, c, t0, bh);
          }
        }
    }
    __syncwarp();
    if (splits > 1) {
      cluster_arrive();   // the consumers' partials
      cluster_wait();
      merge_rows<DP>(part_k, splits, rank, dkb, dk_st, k0, Tk, D, scale);
      merge_rows<DP>(part_v, splits, rank, dvb, dv_st, k0, Tk, D, 1.f);
      cluster_arrive();   // the peers have read this block's partials
      cluster_wait();
    }
    return;
  }

  if constexpr (NW > 1) setmaxnreg_inc<232>();
  const int cw = tid / kGroup, w = (tid / 32) % 4, g = lane >> 2, qd = lane & 3;
  const int ksteps = (D + 7) / 8;
  const int row0 = 16 * w + g;
  const Ring ring = ring_of(cw);
  const int my_lo = lo_of(cw), my_own = own_of(cw);
  // this thread's keys k0 + row0 and + 8: their bias (log2 domain)
  float kb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + 8 * r;
    kb[r] = key >= Tk ? -CUDART_INF_F
            : kBias   ? bias[int64_t(b) * Tk + key] * kLog2e
                      : 0.f;
  }
  const int64_t row_at = int64_t(bh) * tq_pad;
  int uc = 0, held = 0;
  mbar_wait(kvfull, 0);

  Acc<DP> dK, dV;
#pragma unroll
  for (int c = 0; c < NP; ++c)
#pragma unroll
    for (int e = 0; e < PC / 2; ++e) dK[c][e] = dV[c][e] = 0.f;
  float S[BN / 2], dP[BN / 2];
  uint32_t pb[BN / 8][4], ps[BN / 8][4], db[BN / 8][4], ds[BN / 8][4];
  for (int i = 0; i < my_own; ++i) {
    const int t0 = (my_lo + i) * BN;
    // queries 8c + 2qd, + 1 of the tile: their lse and Delta
    float2 ls[BN / 8], dl[BN / 8];
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      ls[c] = __ldg(reinterpret_cast<const float2*>(lse_ws + row_at + t0 +
                                                    8 * c + 2 * qd));
      dl[c] = __ldg(reinterpret_cast<const float2*>(delta_ws + row_at + t0 +
                                                    8 * c + 2 * qd));
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) S[e] = dP[e] = 0.f;
#pragma unroll
    for (int c = 0; c < NP; ++c) {   // S^T and dP^T over the chunks
      ring_take(ring, uc, held, [&](uint32_t slot) {
        chunk3<DP, BN>(S, k_b + c * F::Panel, k_s + c * F::Panel, slot,
                       slot + R::Panel, c * (PC / 8), ksteps);
      });
      ring_take(ring, uc, held, [&](uint32_t slot) {
        chunk3<DP, BN>(dP, v_b + c * F::Panel, v_s + c * F::Panel, slot,
                       slot + R::Panel, c * (PC / 8), ksteps);
      });
    }
    ring_drain(ring, uc, held);
    fence_all(S);
    fence_all(dP);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {   // queries 8c + 2qd, + 1
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * c + r;
        const float p = ex2_approx(fmaf(S[e], scale_log2, kb[r >> 1]) -
                                   ((r & 1) ? ls[c].y : ls[c].x));
        S[e] = p;
        dP[e] = p * (dP[e] - ((r & 1) ? dl[c].y : dl[c].x));   // dS^T
      }
    }
    to_planes<BN>(S, pb, ps);
    to_planes<BN>(dP, db, ds);
#pragma unroll
    for (int c = 0; c < NP; ++c) {   // dV, dK per chunk
      ring_take(ring, uc, held, [&](uint32_t slot) {
        chunk_t<DP, BN>(dV[c], pb, ps, slot, slot + R::TChunk);
      });
      ring_take(ring, uc, held, [&](uint32_t slot) {
        chunk_t<DP, BN>(dK[c], db, ds, slot, slot + R::TChunk);
      });
    }
    ring_drain(ring, uc, held);
    fence_chunks(dV);
    fence_chunks(dK);
    fence_planes(pb);
    fence_planes(ps);
    fence_planes(db);
    fence_planes(ds);
  }
  if constexpr (NW > 1) {
    // consumer 1's partial dK and dV into consumer 0's, through the ring
    // (every copy has landed and every product has read its operands)
    float* ringf = reinterpret_cast<float*>(smem_raw + (rows0 - raw));
    named_barrier_sync(1, NW * kGroup);
    if (cw == 1) {
      stash_rows<DP>(dK, ringf, row0, qd);
      stash_rows<DP>(dV, ringf + kRows * (DP + 4), row0, qd);
    }
    named_barrier_sync(1, NW * kGroup);
    if (cw == 0) {
      add_rows<DP>(dK, ringf, row0, qd);
      add_rows<DP>(dV, ringf + kRows * (DP + 4), row0, qd);
    }
  }
  if (splits == 1) {
    if (cw == 0) {
      store_rows<DP>(dK, dkb, dk_st, k0 + row0, Tk, D, qd, scale);
      store_rows<DP>(dV, dvb, dv_st, k0 + row0, Tk, D, qd, 1.f);
    }
    return;
  }
  // the ranks' partial dK and dV over the fixed tile's planes (every
  // product has read them), summed in rank order
  named_barrier_sync(1, NW * kGroup);
  float* part = reinterpret_cast<float*>(smem_raw + (base - raw));
  if (cw == 0) {
    stash_rows<DP>(dK, part, row0, qd);
    stash_rows<DP>(dV, part + kRows * (DP + 4), row0, qd);
  }
  cluster_arrive();
  cluster_wait();
  merge_rows<DP>(part_k, splits, rank, dkb, dk_st, k0, Tk, D, scale);
  merge_rows<DP>(part_v, splits, rank, dvb, dv_st, k0, Tk, D, 1.f);
  cluster_arrive();
  cluster_wait();
}


// a 4-D f32 tensor map over planes (2, BH, rows, cols), a box of `bc`
// columns x `br` rows of one (batch*head, plane), swizzled over `bc` floats
int plane_map(CUtensorMap* map, const float* p, int BH, int rows, int cols,
              int bc, int br) {
  const uint64_t dims[4] = {uint64_t(cols), uint64_t(rows), uint64_t(BH), 2};
  const uint64_t strides[3] = {uint64_t(cols) * 4,
                               uint64_t(rows) * cols * 4,
                               uint64_t(BH) * rows * cols * 4};
  const uint32_t box[4] = {uint32_t(bc), uint32_t(br), 1, 1};
  return encode_f32_map(map, p, 4, dims, strides, box,
                        bc == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Call {
  const void *q, *k, *v, *dout;
  const float* bias;
  void *dq, *dk, *dv;
  float* ws;
  int B, H, Tq, Tk, D, Din;
  const int64_t* s;
  float scale;
  int dq_splits, kv_splits;
  cudaStream_t stream;
};

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, int smem,
                           int splits, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the workspace (f32 values), each part at a multiple of 32 values: lse and
// Delta (BH, Tq_pad) each; the row planes of q, k, v, dO (2, BH, T, DP);
// the transposes of q, k, dO (2, BH, DP, T8). ops/flash_attention.py
// `f32_bwd_workspace` mirrors it.
struct Planes {
  float *lse, *delta, *q, *k, *v, *dout, *qt, *kt, *dot;
};

inline int64_t up32(int64_t n) { return (n + 31) / 32 * 32; }

Planes planes(float* ws, int BH, int Tq, int Tk, int DP) {
  const int64_t tq_pad = (Tq + kRows - 1) / kRows * kRows;
  const int64_t tq8 = (Tq + 7) / 8 * 8, tk8 = (Tk + 7) / 8 * 8;
  Planes p;
  float* at = ws;
  auto take = [&](int64_t n) {
    float* r = at;
    at += up32(n);
    return r;
  };
  p.lse = take(BH * tq_pad);
  p.delta = take(BH * tq_pad);
  p.q = take(2 * int64_t(BH) * Tq * DP);
  p.k = take(2 * int64_t(BH) * Tk * DP);
  p.v = take(2 * int64_t(BH) * Tk * DP);
  p.dout = take(2 * int64_t(BH) * Tq * DP);
  p.qt = take(2 * int64_t(BH) * DP * tq8);
  p.kt = take(2 * int64_t(BH) * DP * tk8);
  p.dot = take(2 * int64_t(BH) * DP * tq8);
  return p;
}

template <int DP, bool kBias>
int launch(const Call& c) {
  constexpr int BN = Shape<DP>::BN, KBN = Shape<DP>::KBN;
  using F = Rows<DP, kRows>;
  using R = Rows<DP, BN>;
  using RK = Rows<DP, KBN>;
  const int64_t* s = c.s;
  const int BH = c.B * c.H;
  if (c.dq_splits > (c.Tk + BN - 1) / BN ||
      c.kv_splits > (c.Tq + KBN - 1) / KBN)
    return int(cudaErrorInvalidValue);
  const int tq8 = (c.Tq + 7) / 8 * 8, tk8 = (c.Tk + 7) / 8 * 8;
  const Planes p = planes(c.ws, BH, c.Tq, c.Tk, DP);
  CUtensorMap q64, do64, kbn, vbn, ktbn, k64, v64, qbn, dobn, qtbn, dotbn;
  int r = plane_map(&q64, p.q, BH, c.Tq, DP, F::PC, kRows);
  if (r == 0) r = plane_map(&do64, p.dout, BH, c.Tq, DP, F::PC, kRows);
  if (r == 0) r = plane_map(&kbn, p.k, BH, c.Tk, DP, R::PC, BN);
  if (r == 0) r = plane_map(&vbn, p.v, BH, c.Tk, DP, R::PC, BN);
  if (r == 0) r = plane_map(&ktbn, p.kt, BH, DP, tk8, R::KP, R::PC);
  if (r == 0) r = plane_map(&k64, p.k, BH, c.Tk, DP, F::PC, kRows);
  if (r == 0) r = plane_map(&v64, p.v, BH, c.Tk, DP, F::PC, kRows);
  if (r == 0) r = plane_map(&qbn, p.q, BH, c.Tq, DP, RK::PC, KBN);
  if (r == 0) r = plane_map(&dobn, p.dout, BH, c.Tq, DP, RK::PC, KBN);
  if (r == 0) r = plane_map(&qtbn, p.qt, BH, DP, tq8, RK::KP, RK::PC);
  if (r == 0) r = plane_map(&dotbn, p.dot, BH, DP, tq8, RK::KP, RK::PC);
  if (r != 0) return r;
  static bool a_set[kMaxDevices] = {}, b_set[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(flash_bwd_f32_dq_kernel<DP, kBias>,
                                       DqSmem<DP>::Bytes, a_set);
  if (err == cudaSuccess)
    err = allow_dynamic_smem(flash_bwd_f32_dkdv_kernel<DP, kBias>,
                             KvSmem<DP>::Bytes, b_set);
  if (err != cudaSuccess) return int(err);
  const Operand ops[4] = {
      {static_cast<const float*>(c.q), s[0], s[1], s[2], c.Tq, tq8, p.q, p.qt},
      {static_cast<const float*>(c.k), s[3], s[4], s[5], c.Tk, tk8, p.k, p.kt},
      {static_cast<const float*>(c.v), s[6], s[7], s[8], c.Tk, tk8, p.v,
       nullptr},
      {static_cast<const float*>(c.dout), s[9], s[10], s[11], c.Tq, tq8,
       p.dout, p.dot}};
  const int tmax = (std::max(tq8, tk8) + kRows - 1) / kRows;
  flash_bwd_f32_convert_kernel<DP><<<dim3(tmax, BH, 4), 256, 0, c.stream>>>(
      ops[0], ops[1], ops[2], ops[3], c.H, c.Din, BH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int tq_pad = (c.Tq + kRows - 1) / kRows * kRows;
  const float sl2 = c.scale * kLog2e;
  err = launch_cluster(flash_bwd_f32_dq_kernel<DP, kBias>,
                       dim3(tq_pad / kRows * c.dq_splits, BH),
                       kThreadsOf<DP>, DqSmem<DP>::Bytes, c.dq_splits,
                       c.stream, q64, do64,
                       kbn, vbn, ktbn, c.bias, static_cast<float*>(c.dq),
                       p.lse, p.delta, c.H, c.Tq, c.Tk, c.D, tq_pad, s[12],
                       s[13], s[14], sl2, c.scale, c.dq_splits);
  if (err != cudaSuccess) return int(err);
  err = launch_cluster(
      flash_bwd_f32_dkdv_kernel<DP, kBias>,
      dim3((c.Tk + kRows - 1) / kRows * c.kv_splits, BH), kThreadsOf<DP>,
      KvSmem<DP>::Bytes, c.kv_splits, c.stream, k64, v64, qbn, dobn, qtbn, dotbn, c.bias,
      static_cast<const float*>(p.lse), static_cast<const float*>(p.delta),
      static_cast<float*>(c.dk), static_cast<float*>(c.dv), c.H, c.Tq, c.Tk,
      c.D, tq_pad, s[15], s[16], s[17], s[18], s[19], s[20], sl2, c.scale,
      c.kv_splits);
  return int(err);
}

template <int DP>
int launch_dp(const Call& c) {
  return c.bias ? launch<DP, true>(c) : launch<DP, false>(c);
}

}  // namespace
}  // namespace ns2vc

// f32 q, k, v, dout (the gradient of o) as (B, H, T, Din) views by element
// strides (batch, head, seq) with unit stride on the head dim, any
// alignment; bias (B, Tk) f32 contiguous or null; dq, dk, dv f32 (B, H, T,
// D) views by their strides (rows 8-byte aligned), written in columns
// below D = Din rounded up to 4 (the caller drops the columns past Din);
// scale the forward's. The 21 strides: q, k, v, dout, dq, dk, dv, three
// each. dq_splits, kv_splits: the clusters of `plan_f32_backward`, 1 to 8,
// each at most the streamed tiles (ceil(Tk / BN) and ceil(Tq / BN)). The
// caller guarantees 1 <= Din <= 128, Tq, Tk >= 1, B*H <= 65535; ws: the f32
// workspace of `f32_bwd_workspace` (the `Planes` layout), 16-byte aligned.
// Returns the CUDA error of its launches (0 on success), or a negative
// code from a tensor map (-1: libcuda's encoder was not found; -(1000 +
// r): it returned CUresult r).
extern "C" int ns2vc_flash_attention_f32_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, void* dq, void* dk, void* dv, void* ws, int B, int H,
    int Tq, int Tk, int Din, int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
    int64_t v_st, int64_t do_sb, int64_t do_sh, int64_t do_st, int64_t dq_sb,
    int64_t dq_sh, int64_t dq_st, int64_t dk_sb, int64_t dk_sh, int64_t dk_st,
    int64_t dv_sb, int64_t dv_sh, int64_t dv_st, float scale, int dq_splits,
    int kv_splits, void* stream) {
  using namespace ns2vc;
  const int64_t s[21] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,  k_st,  v_sb,
                         v_sh,  v_st,  do_sb, do_sh, do_st, dq_sb, dq_sh,
                         dq_st, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st};
  const Call c{q,  k,  v,  dout, static_cast<const float*>(bias),
               dq, dk, dv, static_cast<float*>(ws), B, H, Tq, Tk,
               (Din + 3) / 4 * 4, Din, s, scale, dq_splits, kv_splits,
               static_cast<cudaStream_t>(stream)};
  if (Din < 1 || Din > 128 || dq_splits < 1 || dq_splits > kMaxSplits ||
      kv_splits < 1 || kv_splits > kMaxSplits)
    return int(cudaErrorInvalidValue);
  if (Din <= 16) return launch_dp<16>(c);
  if (Din <= 32) return launch_dp<32>(c);
  if (Din <= 64) return launch_dp<64>(c);
  return launch_dp<128>(c);
}
