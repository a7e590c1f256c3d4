// Flash attention backward on Hopper (sm_90a), bf16 in and out: given
//     o = softmax(q.k^T * scale + key_bias) . v
// and o's gradient dO, it computes
//     P = softmax(q.k^T * scale + key_bias)           (recomputed, f32)
//     dV = P^T . dO          (P rounded to bf16, as the PV product takes it)
//     dP = dO . V^T,  Delta = rowsum(P * dP),  dS = P * (dP - Delta)
//     dQ = dS . K * scale,   dK = dS^T . Q * scale
// q, k, v, dO (B, H, T, D) bf16 views through (batch, head, seq) strides,
// the key bias (B, Tk) f32 or none; dq, dk, dv bf16 through their strides.
//
// Replaces: the torch-ops backward `ops/flash_attention.py::
// flash_attention_backward` (which stays as the plain version) for bf16
// calls, and through it XLA's autodiff of ns2vc_tpu/ops/attention.py::
// scaled_dot_product_attention, the function the Pallas TPU kernel
// ns2vc_tpu/ops/pallas_attention.py::flash_attention computes (forward
// only; the JAX package trains through XLA's attention).
//
// What bounds it on the H100: at a training step's 44 tile calls (B = 32 x
// 272, heads of 16..64) the five products are 0.3 GFLOP a call at most and
// the bytes a few MB: the bound is ~0.3 ms for the step, bytes at most
// calls. A kernel is far from it if it keeps P or dS in device memory, or
// adds them with atomics; the design keeps both in registers and needs
// none. What holds it above the bound (edited copies timed in turns,
// scripts/torch_k1_bwd_variants.py): latency. The earlier design (a block
// per item, commit 7602d88) spent half its time in the products' round
// trips with two consumer warpgroups an SM, and each block paid its
// set-up, its fixed tiles' loads and its epilogue alone (most of a
// block's time at 34 or 68 queries over 272 keys); the exponentials cost
// nothing measurable, and a register cap for a third block an SM spills
// and loses.
//
// Precision: Delta is rowsum(P * dP) over the f32 P and dP the kernels
// compute, never rowsum(dO * O) over the bf16 O (whose rounding, carried
// into every element of a row, a component the keys share turns into dQ's
// largest error), so each row of dS sums to zero up to f32 rounding. dS
// enters dQ and dK as two bf16 planes (hi = bf16(dS), lo = bf16(dS - hi):
// |dS - hi - lo| <= 2^-17 |dS|), each product exact in f32 and summed in
// f32; one plane's rounding breaks the rows' zero sum by ~2^-9 of |dS|.
//
// Design, two kernels over the tile structure of the forward
// (flash_attention_wgmma.cu: 4-D (D, H, T, B) tensor maps of the strided
// views, 64-row tiles swizzled by the row width, a producer warp that
// issues every TMA copy into a ring of stages, a consumer warpgroup on
// wgmma), no atomics. Each kernel's work is a list of items (64 fixed
// rows of one batch*head, batch*head-major); each producer / consumer
// pair takes a run of consecutive items, an even share (ops/
// flash_attention.py::plan_backward: as many runs as the H100 works at
// once, Cfg::Blocks x Cfg::Pairs an SM), so it pays its set-up once, and
// its producer loads the next item's fixed tiles into the second of two
// fixed buffers, and its streamed tiles into the ring, while the
// consumers finish the item before. At heads of 32 or fewer a block holds
// three pairs, the producers' registers moved to the consumers by
// setmaxnreg (Cfg::Pairs), so three consumer warpgroups fit an SM.
//   - `dq` (kernel A), items of 64 query rows: Q and dO once, then every
//     key tile's K and V twice. Sweep 1: S = Q.K^T and dP = dO.V^T on
//     wgmma m64n64k16 (both operands K-major from shared memory), and per
//     row, online in the log2 domain, the max m, the sum l = sum 2^(x - m)
//     and u = sum 2^(x - m) dP, each rescaled as m moves; then lse = m +
//     log2(l) and Delta = u / l, written to the workspace (rows past Tq:
//     lse = +inf, Delta = 0, so they give P = 0 below). Sweep 2: S and dP
//     again, P = 2^(x - lse), dS, and dQ += dS.K on wgmma with dS's planes
//     as A from registers and K as the transposed (MN-major) B operand;
//   - `dkdv` (kernel B), items of 64 keys: K, V and their bias once, then
//     every query tile's Q, dO, lse and Delta. S^T = K.Q^T and dP^T =
//     V.dO^T (keys along wgmma's M), P^T = 2^(x - lse), dS^T, then dV +=
//     bf16(P^T).dO and dK += dS^T.Q on wgmma, A from registers, Q and dO
//     as MN-major B.
// Overlap: `dq`'s second sweep computes tile j's dS while tile j-1's dQ
// product runs, and issues tile j+1's scores before tile j's product;
// `dkdv` issues tile i+1's S^T and dP^T right after tile i's gradient
// products (the products read the A fragments, the scores write S and
// dP), so both land at one wait. (Measured designs not kept, PERF.md:
// `dq`'s first sweep issuing tile j+1's products into a second set of
// accumulators before summing tile j's was slower; tails of fewer rows as
// narrower products, m64n16k16 .. m64n48k16, with the products over their
// rows cut to their K steps, each chosen at run time, were slower; a
// `dkdv` that also formed dQ (dS^T staged in shared memory, each block
// summing whole batch*heads' dQ there) after `dq`'s first sweep alone
// was no faster.)
// Every sum runs in an order fixed by the shapes (wgmma's within a product,
// the tiles in order, a row's four lanes by xor shuffles) and each item's
// sums in one pair, so two launches on one input give bitwise-equal
// outputs, whatever run an item lands in. Keys past Tk get a bias of -inf
// (P = 0); tiles past T and columns past D arrive as zeros from TMA.
//
// Calls of one query (Tq = 1: the attention pools) take the single-query
// backward (flash_attention_q1_bwd.cu): a tile of 64 query rows would be
// 63 rows of padding, and the products are dot products. Rows TMA cannot
// take of more than one query come from the wrapper as zero-padded
// contiguous copies ("tc_pad").
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;     // rows of every tile: queries or keys
constexpr int kGroup = 128;   // threads of a warpgroup
constexpr int kThreads = kGroup + 32;   // + the producer warp

template <int DP>
struct Cfg {
  static constexpr int W = DP < 64 ? 2 * DP : 128;  // swizzle = panel row bytes
  static constexpr int PC = W / 2;                  // head columns per panel
  static constexpr int NP = DP / PC;                // panels
  static constexpr int Panel = kRows * W;
  static constexpr int TileBytes = NP * Panel;      // one 64-row tile
  static constexpr int StageBytes = 2 * TileBytes;  // K, V or Q, dO
  static constexpr int Stages = DP <= 64 ? 3 : 2;
  // producer / consumer pairs a block: each pair a producer warp and a
  // consumer warpgroup with shared memory of its own, items of its own. At
  // heads of 32 or fewer three pairs, the producers in a fourth warpgroup
  // whose registers `setmaxnreg` moves to the consumers (kConsumerRegs:
  // 146-168 a thread need more than three blocks of 160 threads leave);
  // above, one pair of 160 threads
  static constexpr int Pairs = DP <= 32 ? 3 : 1;
  static constexpr int Threads = Pairs == 1 ? kThreads : (Pairs + 1) * kGroup;
  // blocks an SM holds, by both kernels' launch bounds (ops/
  // flash_attention.py::BWD_RUNS_PER_SM plans the runs: Blocks x Pairs
  // an SM)
  static constexpr int Blocks = Pairs > 1 ? 1 : DP <= 64 ? 2 : 1;
  // a pair's [2 x 2 fixed tiles][Stages x 2 tiles][Stages x 2 x 64
  // floats][2 x 64 floats of the fixed rows], in whole 1024-byte atoms
  static constexpr int PairBytes =
      (4 * TileBytes + Stages * StageBytes + (Stages * 2 + 2) * kRows * 4 +
       1023) / 1024 * 1024;
  static constexpr int SmemBytes = 1024 + Pairs * PairBytes;
  static_assert(Panel % 1024 == 0, "atom alignment");
};

// registers a thread of a producer and of a consumer warpgroup hold after
// `setmaxnreg` (512 threads enter with 128: the producers' 96 a thread
// are the consumers' 32 more)
constexpr int kProducerRegs = 32, kConsumerRegs = 160;

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a thread's part: its pair, producer or consumer, and (a producer warp of
// the fourth warpgroup past Pairs) idle
struct Role {
  int pair;
  bool producer, idle;
};

template <int DP>
__device__ __forceinline__ Role role() {
  constexpr int P = Cfg<DP>::Pairs;
  const int tid = threadIdx.x;
  if (tid < P * kGroup) return Role{tid / kGroup, false, false};
  const int pw = (tid - P * kGroup) >> 5;
  return Role{pw < P ? pw : 0, true, pw >= P};
}

// d (64 x 64 f32) = a . b^T, both 64-row K-major tiles in shared memory
// (the forward's Q.K^T), over the K steps that hold head columns
template <int DP>
__device__ __forceinline__ void product_kmajor(float (&d)[32], uint32_t a,
                                               uint32_t b, int ksteps) {
  using C = Cfg<DP>;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    if (ks < ksteps) {
      const uint32_t off = (ks * 16 % C::PC) * 2;   // bytes in a row
      const int pnl = ks * 16 / C::PC;
      wgmma_m64n64k16_ss(
          d, wgmma_desc<C::W>(a + pnl * C::Panel + off, 16, 8 * C::W),
          wgmma_desc<C::W>(b + pnl * C::Panel + off, 16, 8 * C::W), ks > 0);
    }
  }
}

// d (64 x DP f32) += a (64 x 64 bf16, registers: four k16 fragments) . b
// (a 64-row tile read as wgmma's transposed, MN-major, B: its rows along K)
template <int DP>
__device__ __forceinline__ void product_mn(float (&d)[DP / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
  using C = Cfg<DP>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_mn<DP>(d, a[kk],
                    wgmma_desc<C::W>(b + kk * 16 * C::W, C::Panel, 8 * C::W));
}

// an accumulator of 64 x 64 f32 as A fragments (wgmma's m64nNk16 A, four
// K steps of 16 columns) of bf16: one plane, or the rounding's remainder
// as a second
__device__ __forceinline__ void to_frag(const float (&v)[32],
                                        uint32_t (&hi)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hi[kk][r] = pack_bf16x2(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void to_planes(const float (&v)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = v[8 * kk + 2 * r], b = v[8 * kk + 2 * r + 1];
      const uint32_t h = pack_bf16x2(a, b);
      hi[kk][r] = h;
      lo[kk][r] = pack_bf16x2(a - __uint_as_float(h << 16),
                              b - __uint_as_float(h & 0xffff0000u));
    }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_operand(r[e]);
}

// rows of a 64 x DP accumulator (this thread's rows `row0` and `row0 + 8`
// of the tile) times `mul` into bf16 rows of `out` below `rows`, columns
// below D (D % 8 == 0: d < D => d + 1 < D)
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           bf16* out, int64_t st, int row0,
                                           int rows, int D, int qd,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    if (t >= rows) continue;
    bf16* orow = out + int64_t(t) * st;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * qd;
      if (d < D)
        *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16x2(
            acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

// the shared memory and barriers both kernels lay out alike: two fixed
// buffers (two 64-row tiles and 64 floats each), a ring of stages (two
// tiles and 2 x 64 floats each)
template <int DP>
struct Layout {
  using C = Cfg<DP>;
  static constexpr int ST = C::Stages;
  uint32_t base;
  uint8_t* base_ptr;
  uint64_t* bars;   // fixed_full[2], fixed_empty[2], full[ST], empty[ST]
  __device__ uint32_t fixed0(int f) const {
    return base + f * 2 * C::TileBytes;
  }
  __device__ uint32_t fixed1(int f) const { return fixed0(f) + C::TileBytes; }
  __device__ uint32_t s0(int s) const {
    return base + 4 * C::TileBytes + s * C::StageBytes;
  }
  __device__ uint32_t s1(int s) const { return s0(s) + C::TileBytes; }
  // per stage 2 x 64 floats
  __device__ float* stage_rows(int s) const {
    return reinterpret_cast<float*>(base_ptr + 4 * C::TileBytes +
                                    ST * C::StageBytes) +
           s * 2 * kRows;
  }
  // per fixed buffer 64 floats
  __device__ float* fixed_rows(int f) const {
    return reinterpret_cast<float*>(base_ptr + 4 * C::TileBytes +
                                    ST * C::StageBytes) +
           ST * 2 * kRows + f * kRows;
  }
  __device__ uint32_t fixed_full(int f) const { return smem_u32(&bars[f]); }
  __device__ uint32_t fixed_empty(int f) const {
    return smem_u32(&bars[2 + f]);
  }
  __device__ uint32_t full(int s) const { return smem_u32(&bars[4 + s]); }
  __device__ uint32_t empty(int s) const { return smem_u32(&bars[4 + ST + s]); }
};

// every pair's barriers set up, then pair `pair`'s layout; bars holds
// Pairs x (4 + 2 Stages)
template <int DP>
__device__ __forceinline__ Layout<DP> layout(uint8_t* smem_raw,
                                             uint64_t* bars, int pair) {
  using C = Cfg<DP>;
  constexpr int NB = 4 + 2 * C::Stages;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    for (int p = 0; p < C::Pairs; ++p) {
      const Layout<DP> P{base, nullptr, bars + p * NB};
      for (int f = 0; f < 2; ++f) {
        mbar_init(P.fixed_full(f), 32);       // the producer warp's lanes
        mbar_init(P.fixed_empty(f), kGroup);  // every consumer thread
      }
      for (int s = 0; s < C::Stages; ++s) {
        mbar_init(P.full(s), 32);
        mbar_init(P.empty(s), kGroup);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();
  const uint32_t at = pair * C::PairBytes;
  return Layout<DP>{base + at, smem_raw + (base - raw) + at, bars + pair * NB};
}

// the producer's loads of one fixed buffer (both tiles of rows r0..r0+63
// of head h, batch b) into fixed buffer f, once the consumers are done
// with the item two before (item n of this block); the side rows (64
// floats) are written by the lanes before they arrive
template <int DP, typename Side>
__device__ __forceinline__ void load_fixed(const Layout<DP>& L, int n,
                                           const CUtensorMap* m0,
                                           const CUtensorMap* m1, int h,
                                           int r0, int b, Side side) {
  using C = Cfg<DP>;
  const int f = n & 1, lane = threadIdx.x & 31;
  if (n >= 2) mbar_wait(L.fixed_empty(f), ((n - 2) >> 1) & 1);
  if (lane == 0) {
    mbar_expect_tx(L.fixed_full(f), 2 * C::TileBytes);
#pragma unroll
    for (int p = 0; p < C::NP; ++p) {
      tma_load_4d(L.fixed0(f) + p * C::Panel, m0, L.fixed_full(f), p * C::PC,
                  h, r0, b);
      tma_load_4d(L.fixed1(f) + p * C::Panel, m1, L.fixed_full(f), p * C::PC,
                  h, r0, b);
    }
  }
  side(L.fixed_rows(f));
  mbar_arrive(L.fixed_full(f));
}

// the producer's loads of ring iteration `it` (both tiles of rows r0..r0+63)
template <int DP, typename Side>
__device__ __forceinline__ void load_stage(const Layout<DP>& L, int it,
                                           const CUtensorMap* m0,
                                           const CUtensorMap* m1, int h,
                                           int r0, int b, Side side) {
  using C = Cfg<DP>;
  constexpr int ST = C::Stages;
  const int s = it % ST, lane = threadIdx.x & 31;
  if (it >= ST) mbar_wait(L.empty(s), ((it / ST) - 1) & 1);
  if (lane == 0) {
    mbar_expect_tx(L.full(s), C::StageBytes);
#pragma unroll
    for (int p = 0; p < C::NP; ++p) {
      tma_load_4d(L.s0(s) + p * C::Panel, m0, L.full(s), p * C::PC, h, r0, b);
      tma_load_4d(L.s1(s) + p * C::Panel, m1, L.full(s), p * C::PC, h, r0, b);
    }
  }
  side(L.stage_rows(s));
  mbar_arrive(L.full(s));
}

__device__ __forceinline__ void prefetch_maps(const CUtensorMap* a,
                                              const CUtensorMap* b,
                                              const CUtensorMap* c,
                                              const CUtensorMap* d) {
  if ((threadIdx.x & 31) == 0) {
    prefetch_tensormap(a);
    prefetch_tensormap(b);
    prefetch_tensormap(c);
    prefetch_tensormap(d);
  }
}

template <int DP, bool kBias>
__global__ void __launch_bounds__(Cfg<DP>::Threads, Cfg<DP>::Blocks)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ bias, bf16* __restrict__ dq,
                    float* __restrict__ lse_ws, float* __restrict__ delta_ws,
                    int H, int Tq, int Tk, int D, int tq_pad, int items,
                    int runs, int64_t dq_sb, int64_t dq_sh, int64_t dq_st,
                    float scale_log2, float scale) {
  using C = Cfg<DP>;
  constexpr int ST = C::Stages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[C::Pairs * (4 + 2 * ST)];
  const Role me = role<DP>();
  const Layout<DP> L = layout<DP>(smem_raw, bars, me.pair);

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int q_tiles = tq_pad / kRows;
  const int n_tiles = (Tk + kRows - 1) / kRows;
  // this pair's run: an even share of the items, `runs` shares in all
  const int vb = blockIdx.x * C::Pairs + me.pair;
  const int first = vb < runs ? int(int64_t(vb) * items / runs) : items;
  const int count =
      vb < runs ? int(int64_t(vb + 1) * items / runs) - first : 0;

  if (me.producer) {
    if constexpr (C::Pairs > 1) setmaxnreg_dec<kProducerRegs>();
    if (me.idle) return;
    // producer: per item Q and dO, then every key tile's K, V and key bias
    // (log2 domain, -inf past Tk), twice
    prefetch_maps(&qmap, &kmap, &vmap, &domap);
    int it = 0;
    for (int n = 0; n < count; ++n) {
      const int item = first + n, bh = item / q_tiles, b = bh / H,
                h = bh % H;
      load_fixed(L, n, &qmap, &domap, h, (item % q_tiles) * kRows, b,
                 [](float*) {});
      const float* brow = kBias ? bias + int64_t(b) * Tk : nullptr;
      for (int i = 0; i < 2 * n_tiles; ++i, ++it) {
        const int j = i % n_tiles;
        load_stage(L, it, &kmap, &vmap, h, j * kRows, b, [&](float* bs) {
#pragma unroll
          for (int r = lane; r < kRows; r += 32) {
            const int key = j * kRows + r;
            bs[r] = key >= Tk ? -CUDART_INF_F
                    : kBias   ? brow[key] * kLog2e
                              : 0.f;
          }
        });
      }
    }
    return;
  }

  if constexpr (C::Pairs > 1) setmaxnreg_inc<kConsumerRegs>();
  const int g = lane >> 2, qd = lane & 3;
  const int ksteps = (D + 15) / 16;
  float S[32], dP[32];
  int it = 0;
  for (int n = 0; n < count; ++n) {
    const int item = first + n, bh = item / q_tiles, b = bh / H, h = bh % H;
    const int q0 = (item % q_tiles) * kRows, f = n & 1;
    const uint32_t q_tile = L.fixed0(f), do_tile = L.fixed1(f);
    // this thread's rows g and g + 8 of its warp's 16: running max (log2
    // domain), its part of the row's sum and of u
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f},
          u[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) S[e] = dP[e] = 0.f;

    // S = Q.K^T and dP = dO.V^T of the tile in stage s, one commit group
    auto scores = [&](float (&s_)[32], float (&dp_)[32], int s) {
      wgmma_fence();
      product_kmajor<DP>(s_, q_tile, L.s0(s), ksteps);
      product_kmajor<DP>(dp_, do_tile, L.s1(s), ksteps);
      wgmma_commit();
    };
    // once they have landed: s_ holds the logits x = s * scale * log2(e) +
    // bias * log2(e)
    auto logits = [&](float (&s_)[32], float (&dp_)[32], int s) {
      fence_all(s_);
      fence_all(dp_);
      const float* bs = L.stage_rows(s);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * c + 2 * qd);
        s_[4 * c] = fmaf(s_[4 * c], scale_log2, bb.x);
        s_[4 * c + 1] = fmaf(s_[4 * c + 1], scale_log2, bb.y);
        s_[4 * c + 2] = fmaf(s_[4 * c + 2], scale_log2, bb.x);
        s_[4 * c + 3] = fmaf(s_[4 * c + 3], scale_log2, bb.y);
      }
    };
    // sweep 1's step over one tile's logits: m, l and u, online
    auto online = [&](const float (&s_)[32], const float (&dp_)[32]) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        mx[0] = fmaxf(mx[0], fmaxf(s_[4 * c], s_[4 * c + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s_[4 * c + 2], s_[4 * c + 3]));
      }
      float ref[2], sum[2] = {0.f, 0.f}, usum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(mx[i], m[i]);
        ref[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i];
        const float alpha = ex2_approx(m[i] - ref[i]);
        l[i] *= alpha;
        u[i] *= alpha;
        m[i] = mx[i];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const float p = ex2_approx(s_[e] - ref[i]);
        sum[i] += p;
        usum[i] = fmaf(p, dp_[e], usum[i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += sum[i];
        u[i] += usum[i];
      }
    };
    auto ready = [&](int i) {   // the ring's iteration i has landed
      mbar_wait(L.full(i % ST), (i / ST) & 1);
    };

    // sweep 1, the ring's iterations it .. it + n_tiles - 1
    mbar_wait(L.fixed_full(f), (n >> 1) & 1);
    for (int j = 0; j < n_tiles; ++j, ++it) {
      ready(it);
      scores(S, dP, it % ST);
      wgmma_wait<0>();
      logits(S, dP, it % ST);
      mbar_arrive(L.empty(it % ST));
      online(S, dP);
    }
    float lse[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      u[i] += __shfl_xor_sync(0xffffffffu, u[i], 1);
      u[i] += __shfl_xor_sync(0xffffffffu, u[i], 2);
      lse[i] = m[i] == -CUDART_INF_F ? CUDART_INF_F : m[i] + log2f(l[i]);
      delta[i] = m[i] == -CUDART_INF_F ? 0.f : u[i] / l[i];
      const int t = q0 + 16 * warp + g + 8 * i;
      if (qd == 0) {
        const int64_t at = int64_t(bh) * tq_pad + t;
        lse_ws[at] = t < Tq ? lse[i] : CUDART_INF_F;
        delta_ws[at] = t < Tq ? delta[i] : 0.f;
      }
    }

    float dQ[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) dQ[e] = 0.f;
    uint32_t hi[4][4], lo[4][4];
    // sweep 2, the ring's next n_tiles iterations: tile j's dS is computed
    // while tile j-1's dQ product runs, and tile j+1's S and dP are issued
    // before tile j's dQ product
    const int it0 = it;
    ready(it0);
    scores(S, dP, it0 % ST);
    wgmma_wait<0>();
    for (int j = 0; j < n_tiles; ++j) {
      const int i2 = it0 + j, s = i2 % ST;
      logits(S, dP, s);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        S[e] = ex2_approx(S[e] - lse[i]) * (dP[e] - delta[i]);   // dS
      }
      wgmma_wait<0>();   // tile j-1's dQ product is done with hi, lo, its K
      fence_all(dQ);
      if (j > 0) mbar_arrive(L.empty((i2 - 1) % ST));
      to_planes(S, hi, lo);
      if (j + 1 < n_tiles) {
        ready(i2 + 1);
        scores(S, dP, (i2 + 1) % ST);
      }
      wgmma_fence();
      product_mn<DP>(dQ, hi, L.s0(s));
      product_mn<DP>(dQ, lo, L.s0(s));
      wgmma_commit();
      wgmma_wait<1>();   // the groups retire in order: tile j+1's S, dP
    }
    wgmma_wait<0>();
    fence_all(dQ);
    it = it0 + n_tiles;
    mbar_arrive(L.empty((it - 1) % ST));
    mbar_arrive(L.fixed_empty(f));   // Q and dO read by every product
    store_rows<DP>(dQ, dq + int64_t(b) * dq_sb + int64_t(h) * dq_sh, dq_st,
                   q0 + 16 * warp + g, Tq, D, qd, scale);
  }
}

template <int DP, bool kBias>
__global__ void __launch_bounds__(Cfg<DP>::Threads, Cfg<DP>::Blocks)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const float* __restrict__ bias,
                      const float* __restrict__ lse_ws,
                      const float* __restrict__ delta_ws,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                      int Tq, int Tk, int D, int tq_pad, int items, int runs,
                      int64_t dk_sb, int64_t dk_sh, int64_t dk_st,
                      int64_t dv_sb, int64_t dv_sh, int64_t dv_st,
                      float scale_log2, float scale) {
  using C = Cfg<DP>;
  constexpr int ST = C::Stages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[C::Pairs * (4 + 2 * ST)];
  const Role me = role<DP>();
  const Layout<DP> L = layout<DP>(smem_raw, bars, me.pair);

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int k_tiles = (Tk + kRows - 1) / kRows;
  const int n_q = tq_pad / kRows;
  // this pair's run: an even share of the items, `runs` shares in all
  const int vb = blockIdx.x * C::Pairs + me.pair;
  const int first = vb < runs ? int(int64_t(vb) * items / runs) : items;
  const int count =
      vb < runs ? int(int64_t(vb + 1) * items / runs) - first : 0;

  if (me.producer) {
    if constexpr (C::Pairs > 1) setmaxnreg_dec<kProducerRegs>();
    if (me.idle) return;
    // producer: per item K, V and the keys' bias (log2 domain, -inf past
    // Tk), then every query tile's Q, dO, lse and Delta
    prefetch_maps(&qmap, &kmap, &vmap, &domap);
    int it = 0;
    for (int n = 0; n < count; ++n) {
      const int item = first + n, bh = item / k_tiles, b = bh / H,
                h = bh % H, k0 = (item % k_tiles) * kRows;
      load_fixed(L, n, &kmap, &vmap, h, k0, b, [&](float* kb) {
#pragma unroll
        for (int r = lane; r < kRows; r += 32) {
          const int key = k0 + r;
          kb[r] = key >= Tk ? -CUDART_INF_F
                  : kBias   ? bias[int64_t(b) * Tk + key] * kLog2e
                            : 0.f;
        }
      });
      const int64_t row_at = int64_t(bh) * tq_pad;
      for (int i = 0; i < n_q; ++i, ++it) {
        load_stage(L, it, &qmap, &domap, h, i * kRows, b, [&](float* rs) {
#pragma unroll
          for (int r = lane; r < kRows; r += 32) {
            rs[r] = lse_ws[row_at + i * kRows + r];
            rs[kRows + r] = delta_ws[row_at + i * kRows + r];
          }
        });
      }
    }
    return;
  }

  if constexpr (C::Pairs > 1) setmaxnreg_inc<kConsumerRegs>();
  const int g = lane >> 2, qd = lane & 3;
  const int ksteps = (D + 15) / 16;
  float S[32], dP[32];
  uint32_t pf[4][4], hi[4][4], lo[4][4];
  int it = 0;
  for (int n = 0; n < count; ++n) {
    const int item = first + n, bh = item / k_tiles, b = bh / H, h = bh % H;
    const int k0 = (item % k_tiles) * kRows, f = n & 1;
    const uint32_t k_tile = L.fixed0(f), v_tile = L.fixed1(f);
    float dK[DP / 2], dV[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) dK[e] = dV[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) S[e] = dP[e] = 0.f;
    // S^T = K.Q^T and dP^T = V.dO^T of the query tile in stage s
    auto scores = [&](int s) {
      wgmma_fence();
      product_kmajor<DP>(S, k_tile, L.s0(s), ksteps);
      product_kmajor<DP>(dP, v_tile, L.s1(s), ksteps);
      wgmma_commit();
    };

    mbar_wait(L.fixed_full(f), (n >> 1) & 1);
    // this thread's keys k0 + 16 warp + g and + 8: their bias (log2 domain)
    float kb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) kb[i] = L.fixed_rows(f)[16 * warp + g + 8 * i];
    // query tile i's gradient products and tile i + 1's scores run as one
    // round trip: the products read the A fragments, the scores write S,
    // dP
    const int it0 = it;
    mbar_wait(L.full(it0 % ST), (it0 / ST) & 1);
    scores(it0 % ST);
    for (int i = 0; i < n_q; ++i) {
      const int s = (it0 + i) % ST;
      wgmma_wait<0>();   // tile i's scores and tile i - 1's products
      fence_all(S);
      fence_all(dP);
      fence_all(dK);
      fence_all(dV);
      if (i > 0) mbar_arrive(L.empty((it0 + i - 1) % ST));
      const float* rs = L.stage_rows(s);
#pragma unroll
      for (int c = 0; c < 8; ++c) {   // queries 8c + 2qd, + 1
        const float2 ls = *reinterpret_cast<const float2*>(rs + 8 * c + 2 * qd);
        const float2 dl =
            *reinterpret_cast<const float2*>(rs + kRows + 8 * c + 2 * qd);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 4 * c + r;
          const float p = ex2_approx(fmaf(S[e], scale_log2, kb[r >> 1]) -
                                     ((r & 1) ? ls.y : ls.x));
          S[e] = p;
          dP[e] = p * (dP[e] - ((r & 1) ? dl.y : dl.x));   // dS^T
        }
      }
      to_frag(S, pf);
      to_planes(dP, hi, lo);
      wgmma_fence();
      product_mn<DP>(dV, pf, L.s1(s));
      product_mn<DP>(dK, hi, L.s0(s));
      product_mn<DP>(dK, lo, L.s0(s));
      wgmma_commit();
      if (i + 1 < n_q) {
        mbar_wait(L.full((it0 + i + 1) % ST), ((it0 + i + 1) / ST) & 1);
        scores((it0 + i + 1) % ST);
      }
    }
    wgmma_wait<0>();
    fence_all(dK);
    fence_all(dV);
    it = it0 + n_q;
    mbar_arrive(L.empty((it - 1) % ST));
    mbar_arrive(L.fixed_empty(f));   // K and V read by every product
    const int row0 = k0 + 16 * warp + g;
    store_rows<DP>(dK, dk + int64_t(b) * dk_sb + int64_t(h) * dk_sh, dk_st,
                   row0, Tk, D, qd, scale);
    store_rows<DP>(dV, dv + int64_t(b) * dv_sb + int64_t(h) * dv_sh, dv_st,
                   row0, Tk, D, qd, 1.f);
  }
}

// one operand's tensor map: (D, H, T, B) with element strides (sh, st,
// sb), a box of PC columns x 64 rows of one head, swizzled as the tiles
int encode_map(CUtensorMap* map, const void* p, int B, int H, int T, int D,
               int64_t sb, int64_t sh, int64_t st, int pc) {
  const int64_t outer[3][2] = {{sh, H}, {st, T}, {sb, B}};
  uint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of one element is never stepped over: any multiple of
    // 16 bytes will do for its stride
    const uint64_t v = uint64_t(outer[i][0]) * 2;
    strides[i] = outer[i][1] > 1 || (v > 0 && v % 16 == 0) ? v : 16;
  }
  const uint64_t dims[4] = {uint64_t(D), uint64_t(H), uint64_t(T),
                            uint64_t(B)};
  const uint32_t box[4] = {uint32_t(pc), 1, uint32_t(kRows), 1};
  const CUtensorMapSwizzle sw = pc == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : pc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_bf16_map(map, p, 4, dims, strides, box, sw);
}

struct Call {
  const void *q, *k, *v, *dout;
  const float* bias;
  void *dq, *dk, *dv;
  float* ws;
  int B, H, Tq, Tk, D;
  const int64_t* s;
  float scale;
  int dq_runs, kv_runs;
  cudaStream_t stream;
};

template <int DP, bool kBias>
int launch(const Call& c) {
  using C = Cfg<DP>;
  const int64_t* s = c.s;
  CUtensorMap qm, km, vm, dom;
  int r = encode_map(&qm, c.q, c.B, c.H, c.Tq, c.D, s[0], s[1], s[2], C::PC);
  if (r == 0)
    r = encode_map(&km, c.k, c.B, c.H, c.Tk, c.D, s[3], s[4], s[5], C::PC);
  if (r == 0)
    r = encode_map(&vm, c.v, c.B, c.H, c.Tk, c.D, s[6], s[7], s[8], C::PC);
  if (r == 0)
    r = encode_map(&dom, c.dout, c.B, c.H, c.Tq, c.D, s[9], s[10], s[11],
                   C::PC);
  if (r != 0) return r;
  static bool a_set[kMaxDevices] = {}, b_set[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(flash_bwd_dq_kernel<DP, kBias>,
                                       C::SmemBytes, a_set);
  if (err == cudaSuccess)
    err = allow_dynamic_smem(flash_bwd_dkdv_kernel<DP, kBias>, C::SmemBytes,
                             b_set);
  if (err != cudaSuccess) return int(err);
  const int tq_pad = (c.Tq + kRows - 1) / kRows * kRows;
  const int bh = c.B * c.H;
  const int64_t rows = int64_t(bh) * tq_pad;
  float* lse = c.ws;
  float* delta = c.ws + rows;
  const float sl2 = c.scale * kLog2e;
  const int dq_items = bh * (tq_pad / kRows);
  const int kv_items = bh * ((c.Tk + kRows - 1) / kRows);
  // the plan's runs (at most one per item), one per pair of a block
  const int dq_runs = min(c.dq_runs, dq_items), kv_runs = min(c.kv_runs,
                                                              kv_items);
  flash_bwd_dq_kernel<DP, kBias>
      <<<(dq_runs + C::Pairs - 1) / C::Pairs, C::Threads, C::SmemBytes,
         c.stream>>>(qm, km, vm, dom, c.bias, static_cast<bf16*>(c.dq), lse,
                     delta, c.H, c.Tq, c.Tk, c.D, tq_pad, dq_items, dq_runs,
                     s[12], s[13], s[14], sl2, c.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_bwd_dkdv_kernel<DP, kBias>
      <<<(kv_runs + C::Pairs - 1) / C::Pairs, C::Threads, C::SmemBytes,
         c.stream>>>(qm, km, vm, dom, c.bias, lse, delta,
                     static_cast<bf16*>(c.dk), static_cast<bf16*>(c.dv), c.H,
                     c.Tq, c.Tk, c.D, tq_pad, kv_items, kv_runs, s[15], s[16],
                     s[17], s[18], s[19], s[20], sl2, c.scale);
  return int(cudaGetLastError());
}

template <int DP>
int launch_dp(const Call& c) {
  return c.bias ? launch<DP, true>(c) : launch<DP, false>(c);
}

Call make_call(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, void* dq, void* dk, void* dv, void* ws,
               int B, int H, int Tq, int Tk, int D, const int64_t* s,
               float scale, int dq_runs, int kv_runs, void* stream) {
  return Call{q, k, v, dout, static_cast<const float*>(bias), dq, dk, dv,
              static_cast<float*>(ws), B, H, Tq, Tk, D, s, scale, dq_runs,
              kv_runs, static_cast<cudaStream_t>(stream)};
}

}  // namespace
}  // namespace ns2vc

#define NS2VC_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *bias,             \
      const void *dout, void *dq, void *dk, void *dv, void *ws, int B, int H, \
      int Tq, int Tk, int D, int64_t q_sb, int64_t q_sh, int64_t q_st,        \
      int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,   \
      int64_t v_st, int64_t do_sb, int64_t do_sh, int64_t do_st,              \
      int64_t dq_sb, int64_t dq_sh, int64_t dq_st, int64_t dk_sb,             \
      int64_t dk_sh, int64_t dk_st, int64_t dv_sb, int64_t dv_sh,             \
      int64_t dv_st, float scale, int dq_runs, int kv_runs, void *stream
#define NS2VC_BWD_CALL                                                        \
  const int64_t s[21] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,  k_st,  v_sb,     \
                         v_sh,  v_st,  do_sb, do_sh, do_st, dq_sb, dq_sh,     \
                         dq_st, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st};    \
  const ns2vc::Call c = ns2vc::make_call(q, k, v, bias, dout, dq, dk, dv, ws, \
                                         B, H, Tq, Tk, D, s, scale, dq_runs,  \
                                         kv_runs, stream)

// bf16 q, k, v, dout (the gradient of o) as (B, H, T, D) views by element
// strides (batch, head, seq) with unit stride on D; bias (B, Tk) f32
// contiguous or null; dq, dk, dv bf16 (B, H, T, D) views by their strides
// (rows 4-byte aligned), written whole; scale the forward's. The 21
// strides: q, k, v, dout, dq, dk, dv, three each. dq_runs, kv_runs: the
// runs the dq and the dkdv kernel's items (64 fixed rows, batch*head) go
// in, as even shares, one per producer / consumer pair (ops/
// flash_attention.py::plan_backward), >= 1. Returns the
// CUDA error of its launches (0 on success), or a negative code from a
// tensor map (-1: libcuda's encoder was not found; -(1000 + r): it
// returned CUresult r).
//
// The tile kernels (dq, then dkdv): 1 <= D <= 128 with D % 8 == 0, Tq, Tk
// >= 1, q, k, v, dout 16-byte aligned with strides of whole 16-byte chunks
// (TMA's rule); ws: f32 workspace of 2 * B * H * Tq_pad values, Tq_pad =
// Tq rounded up to 64 (each row's lse, then its Delta).
extern "C" int ns2vc_flash_attention_bwd_wgmma(NS2VC_BWD_ARGS) {
  using namespace ns2vc;
  NS2VC_BWD_CALL;
  if (D % 8 != 0 || D < 1 || dq_runs < 1 || kv_runs < 1)
    return int(cudaErrorInvalidValue);
  if (D <= 16) return launch_dp<16>(c);
  if (D <= 32) return launch_dp<32>(c);
  if (D <= 64) return launch_dp<64>(c);
  if (D <= 128) return launch_dp<128>(c);
  return int(cudaErrorInvalidValue);
}
