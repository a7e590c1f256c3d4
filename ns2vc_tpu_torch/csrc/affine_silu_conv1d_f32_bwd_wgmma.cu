// The resnet epilogue's backward on Hopper's tensor cores (sm_90a), for x
// in f32, at f32 accuracy through 3xTF32 on tf32 wgmma, deterministic by
// construction: for
//     z = x a + b,  s = sigmoid(z),  h = z s,
//     y = conv1d_k3_SAME(h, w) + bias
// given dy (B, T, Co) it computes
//     dbias[o]     = sum_{b,t} dy[b,t,o]
//     dw[o,c,k]    = sum_{b,t} dy[b,t,o] h[b,t+k-1,c]      (zero past [0, T))
//     dh[b,t,c]    = sum_{k,o} dy[b,t-k+1,o] w[o,c,k]
//     dz = dh s (1 + z (1 - s)),  dx = dz a,
//     da[b,c] = sum_t dz x,  db[b,c] = sum_t dz.
// x (B, T, C), dy (B, T, Co) channels-last, w (Co, C, 3) torch Conv1d
// layout, a, b (B, C), all f32; so are dx, dw, dbias, da, db. bf16 inputs
// take affine_silu_conv1d_bwd_wgmma.cu.
//
// Replaces: the f32 FFMA kernels that came before it (dgrad, wgrad and
// finalize on the CUDA cores), and through them the XLA-differentiated program of the
// TPU kernel (ns2vc_tpu/ops/pallas_resnet.py::affine_silu_conv1d).
//
// What bounds it on the H100: operations. Two products of 6 B T C Co FLOPs
// each (dh over K = 3 Co, dw over K = B T frames); f32 accuracy takes three
// TF32 passes per product (small.big + big.small + big.big of each
// operand's TF32 halves, the small.small term dropped): at a training
// step's 45 calls (B = 32 x 272, C, Co of 100..1024) 3 x 176 GFLOP over
// 494.7 TFLOP/s, 1.05 ms.
// What the design does about it: the bf16 backward's structure
// (affine_silu_conv1d_bwd_wgmma.cu) on tf32 wgmma. tf32 wgmma reads its
// shared operands K-major only (no transpose), so every operand is laid out
// with its contracted axis contiguous: dy's rows (B T, Co) are already
// K-major for dgrad (K = Co); w is packed once per call as (2, 3, C_pad,
// Co_pad) TF32 planes, output channels contiguous (`pack`); h's planes are
// written transposed, (2, C_pad, B T), frames contiguous, by dgrad's
// epilogue for wgrad (K = frames); and wgrad's dy, contracted over frames,
// is the A operand from registers, loaded from dy's staged rows at the
// tap's row offset. The A operand of both products comes from registers
// (split into TF32 halves there, zeroed where the tap's neighbour frame
// lies in another batch row); the B operands come by TMA into rings of
// shared-memory stages, already split. Four kernels, no atomics:
//   - `pack`: w's two TF32 planes, transposed through shared memory;
//   - `dgrad` (dh; an implicit GEMM of M = 128 frames, two consumer
//     warpgroups of 64, N = 64 input channels, K = 3 Co in chunks of 32
//     output channels, a ring of 3 stages): a producer warp brings per
//     chunk dy's frames [f0 - 1, f0 + 128] (a 2-D (B T, Co) map; TMA fills
//     frames and channels out of range with zeros) and the three taps'
//     planes of w. Epilogue: z, s from x, a, b; dx; h = z s as two TF32
//     planes, transposed through shared memory, into the workspace; per
//     column the sums of dz x and dz over each 64-frame tile's rows, in
//     row order, one partial per batch row the tile touches;
//   - `wgrad` (dw; per block 64 output channels x 64 input channels x 3
//     taps, K = frames in chunks of 32, the chunks of one split of the
//     frame sum, a ring of 8 stages): the producer brings dy's frames [f0 -
//     1, f0 + 32] and h's planes at [f0, f0 + 32) by TMA, with the chunk's
//     batch-row edges as two bit masks; one consumer warpgroup per tap k
//     loads dy's A fragments at row offset 2 - k (dy[f - k + 1] pairs with
//     h[f]). dbias rides along as the row sums of tap 1's A values (blocks
//     of the first input-channel tile). Each split writes its partials;
//   - `finalize`: one thread per output sums the splits' partials of dw and
//     dbias, and each batch row's frame-tile partials of da and db, in
//     index order, and writes dw in (Co, C, 3) layout.
// Every split rounds to TF32 to nearest, ties away from zero, with integer
// operations (as cvt.rna and as ops/fused_resnet.py::tf32_round), and every
// sum runs in an order fixed by the shapes (wgmma's own order within a
// product, the chunks in order, the partials in index order), so two
// launches on one input give bitwise-equal outputs whatever the schedule.
// The wrapper's `plan_wgrad_f32` picks the splits. When TMA cannot describe
// dy (Co % 4 != 0, or dy not 16-byte aligned) the caller passes vec = 0:
// the consumers stage dy by element loads into the same layout. x, a, b
// are read by elements; w's and h's planes always go through TMA.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

constexpr int kGroup = 128;                // threads of a warpgroup
constexpr int kFrames = 64;                // a dgrad consumer's frames; the
                                           // da, db partials' tiles
constexpr int kCols = 64;                  // input channels per tile
constexpr int kRowBytes = 128;             // 32 f32: a swizzled row
// dgrad: [dy halo][w tap 0 big, small][tap 1][tap 2] per stage
constexpr int kOChunk = 32;                // output channels per dgrad chunk
constexpr int kDgFrames = 2 * kFrames;     // a block's frames
constexpr int kDgHalo = kDgFrames + 2;     // staged frames f0 - 1 .. f0 + 128
constexpr int kDgSlab = 17 * 1024;         // the halo's slot, 1024-aligned
constexpr int kWPlane = kCols * kRowBytes; // one tap's 64 x 32 weights, a plane
constexpr int kDgStage = kDgSlab + 6 * kWPlane;
constexpr int kDgStages = 3;
constexpr int kDgThreads = 2 * kGroup + 32;
constexpr int kDgSmem = kDgStages * kDgStage + 1024;
constexpr int kEpi = 65;                   // epilogue tile row (floats)
constexpr int kEpiTile = kFrames * kEpi;
static_assert(kDgHalo * kRowBytes <= kDgSlab, "halo slot");
static_assert(2 * 3 * kEpiTile * 4 <= kDgStages * kDgStage, "epilogue tiles");
// wgrad: [dy halo, channels o0.. and o0 + 32..][h big][h small] per stage
constexpr int kWgFrames = 32;              // frames per chunk
constexpr int kWgRows = 64;                // output channels per block
constexpr int kWgHalo = kWgFrames + 2;     // staged frames f0 - 1 .. f0 + 32
constexpr int kWgPanel = 5 * 1024;         // a halo panel's slot
constexpr int kHPlane = kCols * kRowBytes; // 64 channels x 32 frames
constexpr int kWgStage = 2 * kWgPanel + 2 * kHPlane;
constexpr int kWgStages = 8;
constexpr int kWgThreads = 3 * kGroup + 32;   // a consumer per tap + producer
constexpr int kWgSmem = kWgStages * kWgStage + 1024;
static_assert(kWgHalo * kRowBytes <= kWgPanel, "halo panel slot");

// f32 -> TF32, to nearest, ties away from zero (cvt.rna), by integer
// operations at the full ALU rate (gn_silu_conv1d.cu)
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// z = x a + b as the plain version rounds it (no contraction)
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// the f32 at channel `o` (of 32) of row `row` in a 128-byte-swizzled slab
__device__ __forceinline__ uint32_t slab_at(uint32_t slab, int row, int o) {
  return swz128(slab, row, o >> 2) + 4 * (o & 3);
}

// rows [0, rows) of 32 channels of dy into a 128-byte-swizzled slab by
// element loads: row r holds frame f_first + r (zero outside [0, BT)),
// channels o0 .. o0 + 31 (zero past Co); thread `at` of `threads`
__device__ __forceinline__ void stage_dy_elem(uint32_t slab, const float* dy,
                                              int f_first, int rows, int o0,
                                              int BT, int Co, int at,
                                              int threads) {
  for (int e = at; e < rows * 8; e += threads) {
    const int r = e >> 3, j = e & 7, f = f_first + r, o = o0 + 4 * j;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (f >= 0 && f < BT) {
      const float* row = dy + int64_t(f) * Co;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (o + i < Co) v[i] = __float_as_uint(__ldg(row + o + i));
    }
    sts128(swz128(slab, r, j), make_uint4(v[0], v[1], v[2], v[3]));
  }
}

// A fragment values (raw f32 bits, zeroed by the masks) into their TF32
// halves
__device__ __forceinline__ void split4(const uint32_t (&v)[4],
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(v[e]), big[e], small[e]);
}

// keeps a tap's fragments live until the products that read them are done
__device__ __forceinline__ void fence_frags(uint32_t (&fb)[4][4],
                                            uint32_t (&fs)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fence_operand(fb[ks][e]);
      fence_operand(fs[ks][e]);
    }
}

// w (Co, C, 3) -> its planes (2, 3, Cp, Cop): plane, tap, input channel,
// output channel (contiguous); zero past (C, Co). One block per 32 output
// x 32 input channels, through shared memory
__global__ void __launch_bounds__(256)
pack_wt_kernel(const float* __restrict__ w, float* __restrict__ wt, int C,
               int Co, int Cp, int Cop) {
  __shared__ float tile[32][3 * 32 + 1];
  const int o0 = blockIdx.x * 32, c0 = blockIdx.y * 32, tid = threadIdx.x;
  for (int e = tid; e < 32 * 96; e += 256) {
    const int r = e / 96, j = e % 96, o = o0 + r, c = c0 + j / 3;
    tile[r][j] = o < Co && c < C ? __ldg(w + (int64_t(o) * C + c0) * 3 + j)
                                 : 0.f;
  }
  __syncthreads();
  const int64_t plane = int64_t(3) * Cp * Cop;
  for (int e = tid; e < 3 * 32 * 32; e += 256) {
    const int k = e >> 10, c = (e >> 5) & 31, o = e & 31;
    uint32_t big, small;
    split_tf32(tile[o][3 * c + k], big, small);
    const int64_t at = (int64_t(k) * Cp + c0 + c) * Cop + o0 + o;
    wt[at] = __uint_as_float(big);
    wt[at + plane] = __uint_as_float(small);
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kDgThreads, 1)
dgrad_f32_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap dymap,
                 const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ bsh, const float* __restrict__ dy,
                 float* __restrict__ dx, float* __restrict__ ws_da,
                 float* __restrict__ ws_db, float* __restrict__ ht, int Tlen,
                 int BT, int BTp, int C, int Co, int Cp, int nslot) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kDgStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kCols, f0 = blockIdx.y * kDgFrames;
  const int n = (Co + kOChunk - 1) / kOChunk;
  const int ns = min(n, kDgStages);
  auto stage = [&](int s) { return base + s * kDgStage; };
  auto wplane = [&](int s, int k, int pl) {
    return stage(s) + kDgSlab + (2 * k + pl) * kWPlane;
  };
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[kDgStages + s]); };

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * kGroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 2 * kGroup / 32) {
    // producer: per chunk of 32 output channels, dy's halo (TMA route) and
    // the three taps' weight planes
    if (lane == 0) {
      prefetch_tensormap(&wmap);
      if (kTma) prefetch_tensormap(&dymap);
      for (int i = 0; i < n; ++i) {
        const int s = i % ns, o0 = i * kOChunk;
        if (i >= ns) mbar_wait(empty(s), ((i / ns) - 1) & 1);
        mbar_arrive_expect_tx(
            full(s), 6 * kWPlane + (kTma ? kDgHalo * kRowBytes : 0));
        if (kTma) tma_load_2d(stage(s), &dymap, full(s), o0, f0 - 1);
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
            tma_load_4d(wplane(s, k, pl), &wmap, full(s), o0, c0, k, pl);
      }
    }
    __syncwarp();
    return;
  }

  // consumer warpgroup cw: frames [f0 + 64 cw, f0 + 64 cw + 64), all 64
  // input channels of the tile
  const int cw = warp / 4, wq = warp % 4, g = lane >> 2, q = lane & 3;
  const int at = tid - cw * kGroup;
  const int r_lo = kFrames * cw + 16 * wq + g;   // this thread's rows
  // each chunk's products sum in `part` on the tensor cores, then into acc
  // in f32 (rounded to nearest): a chain of tensor-core accumulations
  // (which do not round to nearest) is one chunk long
  float acc[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part[e] = 0.f;
  // tap k reads dy[f - k + 1] at slab row r + 2 - k: tap 0 reads f + 1,
  // zero at a batch row's last frame; tap 2 reads f - 1, zero at its first
  const int t_lo = (f0 + r_lo) % Tlen, t_hi = (f0 + r_lo + 8) % Tlen;
  const uint32_t keep0_lo = t_lo != Tlen - 1 ? ~0u : 0u;
  const uint32_t keep0_hi = t_hi != Tlen - 1 ? ~0u : 0u;
  const uint32_t keep2_lo = t_lo != 0 ? ~0u : 0u;
  const uint32_t keep2_hi = t_hi != 0 ? ~0u : 0u;
  // A fragments of one tap, TF32 halves (one buffer: two would spill)
  uint32_t ab[4][4], as[4][4];
  for (int i = 0; i < n; ++i) {
    const int s = i % ns;
    const uint32_t slab = stage(s);
    if (!kTma) {
      named_barrier_sync(1, 2 * kGroup);   // both groups are done with it
      stage_dy_elem(slab, dy, f0 - 1, kDgHalo, i * kOChunk, BT, Co, tid,
                    2 * kGroup);
      named_barrier_sync(1, 2 * kGroup);
    }
    mbar_wait(full(s), (i / ns) & 1);
    auto tap = [&](int k, uint32_t(&fb)[4][4], uint32_t(&fs)[4][4],
                   uint32_t keep_lo, uint32_t keep_hi) {
      const int r = r_lo + 2 - k;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t v[4] = {lds32(slab_at(slab, r, 8 * ks + q)) & keep_lo,
                               lds32(slab_at(slab, r + 8, 8 * ks + q)) & keep_hi,
                               lds32(slab_at(slab, r, 8 * ks + q + 4)) & keep_lo,
                               lds32(slab_at(slab, r + 8, 8 * ks + q + 4)) &
                                   keep_hi};
        split4(v, fb[ks], fs[ks]);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t bb = wgmma_desc<128>(wplane(s, k, 0) + 32 * ks, 16, 1024);
        const uint64_t bs = wgmma_desc<128>(wplane(s, k, 1) + 32 * ks, 16, 1024);
        wgmma_tf32_rs<64>(part, fs[ks], bb, k > 0 || ks > 0);
        wgmma_tf32_rs<64>(part, fb[ks], bs, 1);
        wgmma_tf32_rs<64>(part, fb[ks], bb, 1);
      }
      wgmma_commit();
    };
    tap(0, ab, as, keep0_lo, keep0_hi);
    wgmma_wait<0>();
    fence_frags(ab, as);
    tap(1, ab, as, ~0u, ~0u);
    wgmma_wait<0>();
    fence_frags(ab, as);
    tap(2, ab, as, keep2_lo, keep2_hi);
    wgmma_wait<0>();
    fence_frags(ab, as);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      fence_operand(part[e]);
      acc[e] += part[e];
    }
    mbar_arrive(empty(s));
  }

  // every chunk is consumed (so every copy has landed): the stages' memory
  // takes each group's f32 tiles: dh (then dz x), dz, h
  named_barrier_sync(1, 2 * kGroup);
  float* p0 = reinterpret_cast<float*>(smem_raw + (base - raw)) +
              cw * 3 * kEpiTile;
  float* p1 = p0 + kEpiTile;
  float* hb = p1 + kEpiTile;
#pragma unroll
  for (int jn = 0; jn < kCols / 8; ++jn) {
    const int row = 16 * wq + g, col = 8 * jn + 2 * q;
    p0[row * kEpi + col] = acc[4 * jn];
    p0[row * kEpi + col + 1] = acc[4 * jn + 1];
    p0[(row + 8) * kEpi + col] = acc[4 * jn + 2];
    p0[(row + 8) * kEpi + col + 1] = acc[4 * jn + 3];
  }
  named_barrier_sync(2 + cw, kGroup);
  const int fg = f0 + kFrames * cw;   // the group's first frame
  for (int e = at; e < kFrames * kCols; e += kGroup) {
    const int row = e / kCols, col = e % kCols, f = fg + row, c = c0 + col;
    const int i = row * kEpi + col;
    if (f >= BT || c >= C) {
      hb[i] = 0.f;
      continue;
    }
    const int bb = f / Tlen;
    const float xv = __ldg(x + int64_t(f) * C + c);
    const float av = __ldg(a + int64_t(bb) * C + c);
    const float z = affine(xv, av, __ldg(bsh + int64_t(bb) * C + c));
    const float sg = sigmoid(z);
    const float dz = p0[i] * (sg * (1.f + z * (1.f - sg)));
    dx[int64_t(f) * C + c] = dz * av;
    hb[i] = z * sg;
    p0[i] = dz * xv;
    p1[i] = dz;
  }
  named_barrier_sync(2 + cw, kGroup);
  // h's planes, transposed (2, Cp, BTp): 4 frames of one channel a thread
  const int64_t hplane = int64_t(Cp) * BTp;
  for (int e = at; e < kCols * (kFrames / 4); e += kGroup) {
    const int col = e / (kFrames / 4), fr = 4 * (e % (kFrames / 4));
    if (fg + fr >= BTp) continue;
    uint32_t big[4], small[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_tf32(hb[(fr + j) * kEpi + col], big[j], small[j]);
    float* dst = ht + int64_t(c0 + col) * BTp + fg + fr;
    *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(dst + hplane) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }
  // per column: the sums over the tile's rows of dz x (da) and dz (db), in
  // row order, one partial per batch row, at its slot tile - first tile
  const int tile = fg / kFrames, rows = min(kFrames, BT - fg);
  if (rows > 0) {
    const int which = at / kCols, col = at % kCols, c = c0 + col;
    if (c < C) {
      const float* src = (which ? p1 : p0) + col;
      float* dst = which ? ws_db : ws_da;
      int cur = fg / Tlen, next = (cur + 1) * Tlen;
      float sum = 0.f;
      for (int i = 0; i < rows; ++i) {
        if (fg + i == next) {
          dst[(int64_t(cur) * nslot + tile - int64_t(cur) * Tlen / kFrames) *
                  C + c] = sum;
          sum = 0.f;
          ++cur;
          next += Tlen;
        }
        sum += src[i * kEpi];
      }
      dst[(int64_t(cur) * nslot + tile - int64_t(cur) * Tlen / kFrames) * C +
          c] = sum;
    }
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_f32_kernel(const __grid_constant__ CUtensorMap dymap,
                 const __grid_constant__ CUtensorMap hmap,
                 const float* __restrict__ dy, float* __restrict__ ws_dw,
                 float* __restrict__ ws_bias, int Tlen, int BT, int C,
                 int Co) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kWgStages];
  // per stage: the first and the last frame of a batch row among the
  // chunk's 32 frames, one bit each
  __shared__ uint32_t edges[kWgStages][2];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kCols, o0 = blockIdx.y * kWgRows;
  const int split = blockIdx.z, S = gridDim.z;
  const int nq = (BT + kWgFrames - 1) / kWgFrames;
  const int q_lo = int(int64_t(split) * nq / S);
  const int n = int(int64_t(split + 1) * nq / S) - q_lo;
  auto slab = [&](int s, int p) { return base + s * kWgStage + p * kWgPanel; };
  auto hplane = [&](int s, int pl) {
    return base + s * kWgStage + 2 * kWgPanel + pl * kHPlane;
  };
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[kWgStages + s]); };

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 3 * kGroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 3 * kGroup / 32) {
    // producer: per chunk of 32 frames, dy's frames [f0 - 1, f0 + 32] as
    // two 32-channel panels (TMA route), h's two planes at [f0, f0 + 32),
    // and the chunk's batch-row edges
    if (lane == 0) {
      if (kTma) prefetch_tensormap(&dymap);
      prefetch_tensormap(&hmap);
      for (int i = 0; i < n; ++i) {
        const int s = i % kWgStages, f0 = (q_lo + i) * kWgFrames;
        if (i >= kWgStages) mbar_wait(empty(s), ((i / kWgStages) - 1) & 1);
        uint32_t first = 0, last = 0;
        for (int j = 0, t = f0 % Tlen; j < kWgFrames; ++j) {
          first |= uint32_t(t == 0) << j;
          last |= uint32_t(t == Tlen - 1) << j;
          t = t == Tlen - 1 ? 0 : t + 1;
        }
        edges[s][0] = first;
        edges[s][1] = last;
        mbar_arrive_expect_tx(
            full(s), (kTma ? 2 * kWgHalo * kRowBytes : 0) + 2 * kHPlane);
        if (kTma) {
          tma_load_2d(slab(s, 0), &dymap, full(s), o0, f0 - 1);
          tma_load_2d(slab(s, 1), &dymap, full(s), o0 + 32, f0 - 1);
        }
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
          tma_load_3d(hplane(s, pl), &hmap, full(s), f0, c0, pl);
      }
    }
    __syncwarp();
    return;
  }

  // consumer warpgroup k: tap k, A = dy's rows o (M) by frames (K) at the
  // tap's row offset (dy[f - k + 1] pairs with h[f]), B = h's planes
  const int k = warp / 4, wq = warp % 4, g = lane >> 2, q = lane & 3;
  const bool with_bias = blockIdx.x == 0 && k == 1;
  const int o_lo = 16 * wq + g;   // this thread's channels o_lo, o_lo + 8
  // each chunk's products in `part`, then into acc in f32, as dgrad's
  float acc[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part[e] = 0.f;
  float bias_lo = 0.f, bias_hi = 0.f;
  uint32_t fb[4][4], fs[4][4];
  for (int i = 0; i < n; ++i) {
    const int s = i % kWgStages, f0 = (q_lo + i) * kWgFrames;
    if (!kTma) {
      named_barrier_sync(1, 3 * kGroup);   // every tap is done with it
      stage_dy_elem(slab(s, 0), dy, f0 - 1, kWgHalo, o0, BT, Co, tid,
                    3 * kGroup);
      stage_dy_elem(slab(s, 1), dy, f0 - 1, kWgHalo, o0 + 32, BT, Co, tid,
                    3 * kGroup);
      named_barrier_sync(1, 3 * kGroup);
    }
    mbar_wait(full(s), (i / kWgStages) & 1);
    // tap 0 reads dy[f + 1]: zero at a batch row's last frame; tap 2 reads
    // dy[f - 1]: zero at its first
    const uint32_t edge = k == 0 ? edges[s][1] : k == 2 ? edges[s][0] : 0u;
    const uint32_t lo = slab(s, o_lo >> 5), hi = slab(s, (o_lo + 8) >> 5);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int fa = 8 * ks + q, fc = fa + 4;   // the fragment's frames
      const uint32_t ka = (edge >> fa) & 1 ? 0u : ~0u;
      const uint32_t kc = (edge >> fc) & 1 ? 0u : ~0u;
      const uint32_t v[4] = {lds32(slab_at(lo, fa + 2 - k, o_lo & 31)) & ka,
                             lds32(slab_at(hi, fa + 2 - k, (o_lo + 8) & 31)) & ka,
                             lds32(slab_at(lo, fc + 2 - k, o_lo & 31)) & kc,
                             lds32(slab_at(hi, fc + 2 - k, (o_lo + 8) & 31)) & kc};
      if (with_bias) {
        bias_lo += __uint_as_float(v[0]) + __uint_as_float(v[2]);
        bias_hi += __uint_as_float(v[1]) + __uint_as_float(v[3]);
      }
      split4(v, fb[ks], fs[ks]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t hb = wgmma_desc<128>(hplane(s, 0) + 32 * ks, 16, 1024);
      const uint64_t hs = wgmma_desc<128>(hplane(s, 1) + 32 * ks, 16, 1024);
      wgmma_tf32_rs<64>(part, fs[ks], hb, ks > 0);
      wgmma_tf32_rs<64>(part, fb[ks], hs, 1);
      wgmma_tf32_rs<64>(part, fb[ks], hb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(fb, fs);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      fence_operand(part[e]);
      acc[e] += part[e];
    }
    mbar_arrive(empty(s));
  }
  const bool pair = (C & 1) == 0;
#pragma unroll
  for (int jn = 0; jn < kCols / 8; ++jn) {
    const int c = c0 + 8 * jn + 2 * q;
    if (c >= C) continue;
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int o = o0 + o_lo + 8 * hrow;
      if (o >= Co) continue;
      float* d = ws_dw + ((int64_t(split) * 3 + k) * Co + o) * C + c;
      const float v0 = acc[4 * jn + 2 * hrow], v1 = acc[4 * jn + 2 * hrow + 1];
      if (pair) {
        *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
      } else {
        d[0] = v0;
        if (c + 1 < C) d[1] = v1;
      }
    }
  }
  if (with_bias) {
    // the four lanes of a row, in a fixed order
    bias_lo += __shfl_xor_sync(0xffffffffu, bias_lo, 1);
    bias_lo += __shfl_xor_sync(0xffffffffu, bias_lo, 2);
    bias_hi += __shfl_xor_sync(0xffffffffu, bias_hi, 1);
    bias_hi += __shfl_xor_sync(0xffffffffu, bias_hi, 2);
    const int o = o0 + o_lo;
    if (q == 0 && o < Co) ws_bias[int64_t(split) * Co + o] = bias_lo;
    if (q == 0 && o + 8 < Co) ws_bias[int64_t(split) * Co + o + 8] = bias_hi;
  }
}

__global__ void __launch_bounds__(256)
finalize_f32_kernel(const float* __restrict__ ws_dw,
                    const float* __restrict__ ws_bias,
                    const float* __restrict__ ws_da,
                    const float* __restrict__ ws_db, float* __restrict__ dw,
                    float* __restrict__ dbias, float* __restrict__ da,
                    float* __restrict__ db, int B, int Tlen, int C, int Co,
                    int S, int nslot) {
  int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  const int64_t n_w = int64_t(Co) * C;
  if (i < n_w) {
    for (int k = 0; k < 3; ++k) {
      float sum = 0.f;
      for (int s = 0; s < S; ++s) sum += ws_dw[(int64_t(s) * 3 + k) * n_w + i];
      dw[i * 3 + k] = sum;
    }
    return;
  }
  i -= n_w;
  if (i < Co) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += ws_bias[int64_t(s) * Co + i];
    dbias[i] = sum;
    return;
  }
  i -= Co;
  if (i < int64_t(B) * C) {
    const int64_t bb = i / C, c = i % C;
    const int64_t first = bb * Tlen / kFrames;
    const int64_t tiles = (bb * Tlen + Tlen - 1) / kFrames - first + 1;
    float sa = 0.f, sb = 0.f;
    for (int64_t j = 0; j < tiles; ++j) {
      sa += ws_da[(bb * nslot + j) * C + c];
      sb += ws_db[(bb * nslot + j) * C + c];
    }
    da[i] = sa;
    db[i] = sb;
  }
}

// the workspace's layout (f32 values), each part at a multiple of 32
// values: each split's dw and dbias partials, each batch row's da and db
// partials over its nslot frame-tile slots, w's planes (2, 3, Cp, Cop),
// h's planes (2, Cp, BTp). ops/fused_resnet.py `f32_backward_workspace`
// mirrors it.
struct Workspace {
  float *dw, *bias, *da, *db, *wt, *ht;
};

Workspace workspace(void* ws, int B, int C, int Co, int S, int nslot, int Cp,
                    int Cop, int BTp) {
  float* at = static_cast<float*>(ws);
  auto take = [&](int64_t n) {
    float* r = at;
    at += (n + 31) / 32 * 32;
    return r;
  };
  Workspace w;
  w.dw = take(int64_t(S) * 3 * Co * C);
  w.bias = take(int64_t(S) * Co);
  w.da = take(int64_t(B) * nslot * C);
  w.db = take(int64_t(B) * nslot * C);
  w.wt = take(int64_t(2) * 3 * Cp * Cop);
  w.ht = take(int64_t(2) * Cp * BTp);
  return w;
}

template <bool kTma>
cudaError_t launch(const CUtensorMap& wmap, const CUtensorMap& dgmap,
                   const CUtensorMap& wgmap, const CUtensorMap& hmap, const Workspace& ws,
                   const float* x, const float* a, const float* b,
                   const float* w, const float* dy, float* dx, float* da,
                   float* db, float* dw, float* dbias, int B, int Tlen, int C,
                   int Co, int Cp, int Cop, int BTp, int S, int nslot,
                   cudaStream_t st) {
  static bool dg_set[kMaxDevices] = {}, wg_set[kMaxDevices] = {};
  const int BT = B * Tlen;
  cudaError_t err =
      allow_dynamic_smem(dgrad_f32_kernel<kTma>, kDgSmem, dg_set);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(wgrad_f32_kernel<kTma>, kWgSmem, wg_set);
  if (err != cudaSuccess) return err;
  pack_wt_kernel<<<dim3(Cop / 32, Cp / 32), 256, 0, st>>>(w, ws.wt, C, Co,
                                                          Cp, Cop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dgrad_f32_kernel<kTma>
      <<<dim3(Cp / kCols, (BT + kDgFrames - 1) / kDgFrames), kDgThreads,
         kDgSmem, st>>>(wmap, dgmap, x, a, b, dy, dx, ws.da, ws.db, ws.ht,
                        Tlen, BT, BTp, C, Co, Cp, nslot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_f32_kernel<kTma>
      <<<dim3(Cp / kCols, (Co + kWgRows - 1) / kWgRows, S), kWgThreads,
         kWgSmem, st>>>(wgmap, hmap, dy, ws.dw, ws.bias, Tlen, BT, C, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = int64_t(Co) * C + Co + int64_t(B) * C;
  finalize_f32_kernel<<<unsigned((total + 255) / 256), 256, 0, st>>>(
      ws.dw, ws.bias, ws.da, ws.db, dw, dbias, da, db, B, Tlen, C, Co, S,
      nslot);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ns2vc

// x (B, T, C), dy (B, T, Co) f32 contiguous; a, b (B, C) f32 contiguous; w
// (Co, C, 3) f32 contiguous. Writes dx (B, T, C), dw (Co, C, 3), dbias
// (Co,), da, db (B, C), all f32. ws: the f32 workspace of
// `f32_backward_workspace` (the `Workspace` layout; Cp = C rounded up to
// 64, Cop = Co rounded up to 32, BTp = B T rounded up to 4, nslot = (T +
// 62) / 64 + 1, the 64-frame tiles of the flattened B * T frames a batch
// row can touch), 16-byte aligned; S (`splits`, 1 to ceil(B T / 32)) splits
// the weight gradient's frame sum. vec != 0: Co % 4 == 0 and dy 16-byte
// aligned (dy through TMA maps), else element loads. The caller guarantees
// B, T, C, Co >= 1 and ceil(B T / 128) <= 65535. Returns the CUDA error of
// the launches (0 on success), or a negative code from a tensor map.
extern "C" int ns2vc_affine_silu_conv1d_f32_bwd_wgmma(
    const void* x, const void* a, const void* b, const void* w,
    const void* dy, void* dx, void* da, void* db, void* dw, void* dbias,
    void* ws, int B, int Tlen, int C, int Co, int splits, int vec,
    void* stream) {
  using namespace ns2vc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BT = B * Tlen, Cp = (C + 63) / 64 * 64, Cop = (Co + 31) / 32 * 32;
  const int BTp = (BT + 3) / 4 * 4;
  const int nslot = (Tlen + kFrames - 2) / kFrames + 1;
  if (splits < 1 || splits > (BT + kWgFrames - 1) / kWgFrames)
    return int(cudaErrorInvalidValue);
  const Workspace wk = workspace(ws, B, C, Co, splits, nslot, Cp, Cop, BTp);
  CUtensorMap wm, dgm = {}, wgm = {}, hm;
  // w's planes (Cop, Cp, 3, 2): boxes of 32 output x 64 input channels
  const uint64_t wdims[4] = {uint64_t(Cop), uint64_t(Cp), 3, 2};
  const uint64_t wstrides[3] = {uint64_t(Cop) * 4, uint64_t(Cp) * Cop * 4,
                                uint64_t(3) * Cp * Cop * 4};
  const uint32_t wbox[4] = {32, uint32_t(kCols), 1, 1};
  int r = encode_f32_map(&wm, wk.wt, 4, wdims, wstrides, wbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  // h's planes (B T, Cp, 2): boxes of 32 frames x 64 channels
  const uint64_t hdims[3] = {uint64_t(BT), uint64_t(Cp), 2};
  const uint64_t hstrides[2] = {uint64_t(BTp) * 4, uint64_t(Cp) * BTp * 4};
  const uint32_t hbox[3] = {uint32_t(kWgFrames), uint32_t(kCols), 1};
  if (r == 0)
    r = encode_f32_map(&hm, wk.ht, 3, hdims, hstrides, hbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == 0 && vec) {
    // dy (Co, B T): boxes of 32 channels x a halo (dgrad's, wgrad's)
    const uint64_t dims[2] = {uint64_t(Co), uint64_t(BT)};
    const uint64_t strides[1] = {uint64_t(Co) * 4};
    const uint32_t dgbox[2] = {32, uint32_t(kDgHalo)};
    const uint32_t wgbox[2] = {32, uint32_t(kWgHalo)};
    r = encode_f32_map(&dgm, dy, 2, dims, strides, dgbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
    if (r == 0)
      r = encode_f32_map(&wgm, dy, 2, dims, strides, wgbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (r != 0) return r;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* wf = static_cast<const float*>(w);
  const float* dyf = static_cast<const float*>(dy);
  float* outs[5] = {static_cast<float*>(dx), static_cast<float*>(da),
                    static_cast<float*>(db), static_cast<float*>(dw),
                    static_cast<float*>(dbias)};
  auto run = [&](auto tma) {
    return int(launch<decltype(tma)::value>(
        wm, dgm, wgm, hm, wk, xf, af, bf, wf, dyf, outs[0], outs[1],
        outs[2], outs[3], outs[4], B, Tlen, C, Co, Cp, Cop, BTp, splits,
        nslot, st));
  };
  return vec ? run(std::true_type()) : run(std::false_type());
}
