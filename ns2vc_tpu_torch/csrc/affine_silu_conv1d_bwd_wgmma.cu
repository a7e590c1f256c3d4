// The resnet epilogue's backward on Hopper's tensor cores (sm_90a), for x
// in bf16, deterministic by construction: for
//     z = x a + b,  s = sigmoid(z),  h = z s,
//     y = conv1d_k3_SAME(h, w) + bias
// given dy (B, T, Co) it computes
//     dbias[o]     = sum_{b,t} dy[b,t,o]
//     dw[o,c,k]    = sum_{b,t} dy[b,t,o] h[b,t+k-1,c]      (zero past [0, T))
//     dh[b,t,c]    = sum_{k,o} dy[b,t-k+1,o] w[o,c,k]
//     dz = dh s (1 + z (1 - s)),  dx = dz a,
//     da[b,c] = sum_t dz x,  db[b,c] = sum_t dz.
// x (B, T, C), dy (B, T, Co) channels-last bf16; w comes as the forward's
// packed weights (3, Co_pad, C_pad) bf16 through the forward's tensor map
// (ops/fused_resnet.py `packed_weight`, `weight_map`); a, b (B, C) f32.
// dx, dw, dbias are written in the output type O (bf16, or f32 when the
// caller keeps the sums unrounded), da, db in f32. f32 inputs take
// affine_silu_conv1d_bwd.cu.
//
// Replaces: the f32 FFMA kernels of affine_silu_conv1d_bwd.cu for bf16
// (they keep the f32 route), and through them the XLA-differentiated
// program of the TPU kernel (ns2vc_tpu/ops/pallas_resnet.py::
// affine_silu_conv1d).
//
// What bounds it on the H100: operations. Two products of 6 B T C Co FLOPs
// each (dh over K = 3 Co, dw over K = B T frames), 12 B T C Co in all: at a
// training step's 45 calls (B = 32 x 272, C, Co of 128..1024) 176 GFLOP,
// 0.178 ms at 989 TFLOP/s in bf16, against ~0.1 GB moved.
// What the design does about it: both products run on wgmma (bf16 -> f32
// in registers) over tiles that TMA brings into rings of shared-memory
// stages, every frame tile runs over the flattened B * T frames (the deep
// levels' T = 34 and 68 fill whole 64-frame tiles; the SAME halo is
// masked at each batch row's edges), and h is activated once per value,
// in dgrad's epilogue, not once per weight-gradient tile. Three kernels,
// no atomics:
//   - `dgrad` (dh; an implicit GEMM of M = 64 frames, N = 64 input
//     channels, K = 3 Co in chunks of 128 output channels, a ring of up
//     to 3 stages): a producer warp keeps TMA copies in flight, per chunk
//     dy's frames [f0 - 1, f0 + 64] (a 2-D (B T, Co) map; TMA fills frames
//     and channels out of range with zeros) as two 64-channel halves and
//     the three taps' 128 x 64 weight tiles from the forward's packed
//     weights; two consumer warpgroups take one half each: A from
//     registers (ldmatrix of dy's staged rows at offsets 0, 1, 2 for the
//     taps, zeroed in the rows whose neighbour frame lies in another batch
//     row), B the weights read transposed (wgmma's MN-major B: w[o, c, k]
//     multiplies dy's o as it lies), so dy and w, both bf16, multiply
//     exactly and sum in f32, as the plain version's f32 does up to order.
//     Epilogue: both halves' sums through shared memory, added in order;
//     z, s from x, a, b; dx; h = z s as two bf16 planes (h = h0 + h1, h1
//     the rounded remainder: |h - h0 - h1| <= 2^-18 |h|) into the
//     workspace; then per column the sums of dz x and dz over the tile's
//     rows, in row order, one partial per batch row the tile touches;
//   - `wgrad` (dw; per block 64 output channels x 64 input channels x 3
//     taps, K = frames in chunks of 64, the chunks of one split of the
//     frame sum, a ring of 8 stages): the producer brings dy's frames
//     [f0 - 1, f0 + 64] and h's planes at [f0, f0 + 64) by TMA, with the
//     chunk's batch-row edges as two bit masks; one consumer warpgroup per
//     tap k loads dy transposed as A (ldmatrix.trans at row offset 2 - k,
//     so dy[f - k + 1] pairs with h[f], zeroed where that frame lies in
//     another batch row) and runs wgmma m64n64k16 over both planes (B,
//     MN-major): dy x h0 and dy x h1 are exact bf16 products summed in
//     f32. dbias rides along as the row sums of tap 1's A fragments
//     (blocks of the first input-channel tile). Each split writes its
//     partials into the workspace;
//   - `finalize`: one thread per output sums the splits' partials of dw and
//     dbias, and each batch row's frame-tile partials of da and db, in
//     index order, and writes dw in (Co, C, 3) layout.
// Every sum runs in an order fixed by the shapes (wgmma's own order within
// a product, the chunks in order, the partials in index order), so two
// launches on one input give bitwise-equal outputs whatever the schedule.
// The wrapper's `plan_wgrad` picks the splits: weight-gradient tiles times
// splits up to the 132 SMs (one block each), at most 64 and at most the
// frame chunks. When TMA cannot describe dy (C or Co % 8 != 0, or x, dy,
// a, b not 16-byte aligned: the output conv's Co = 100) the caller passes
// vec = 0: the consumers stage dy by element loads into the same layout,
// and dgrad's epilogue reads x, a, b by elements; h's planes, rows of C
// rounded up to 64, always go through TMA.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroup = 128;                // threads of a warpgroup
constexpr int kFrames = 64;                // frames per tile and per chunk
constexpr int kCols = 64;                  // input channels per tile
constexpr int kOChunk = 128;               // output channels per dgrad chunk
constexpr int kStages = 3;
constexpr int kHalo = kFrames + 2;         // staged frames f0 - 1 .. f0 + 64
constexpr int kHaloBytes = kHalo * 128;    // what a halo copy delivers
constexpr int kSlabBytes = 9 * 1024;       // its slot, 1024-byte aligned
constexpr int kPanelBytes = kFrames * 128; // 64 rows of 128 bytes
constexpr int kWTapBytes = kOChunk * 128;  // one tap's 128 x 64 weights

// dgrad: [dy half 0][dy half 1][w tap 0][tap 1][tap 2] per stage
constexpr int kDgThreads = 2 * kGroup + 32;
constexpr int kDgStageBytes = 2 * kSlabBytes + 3 * kWTapBytes;
constexpr int kEpiStride = kCols + 4;      // f32 epilogue tile row (floats)
constexpr int kEpiTileFloats = kFrames * kEpiStride;
static_assert(2 * kEpiTileFloats * 4 <= kDgStageBytes, "epilogue tiles");

// wgrad: [dy halo of 64 output channels][h plane 0][h plane 1] per stage
constexpr int kPlanes = 2;
constexpr int kWgRows = 64;                 // output channels per block
constexpr int kWgStages = 8;
constexpr int kWgThreads = 3 * kGroup + 32; // a consumer per tap + producer
constexpr int kWgStageBytes = kSlabBytes + kPlanes * kPanelBytes;
constexpr size_t kWgSmemBytes = size_t(kWgStages) * kWgStageBytes + 1024;

template <typename O>
__device__ __forceinline__ O from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// z = x a + b as the plain version rounds it (no contraction)
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// 8 values of row `row` (of `cols`) from channel `c` on: 16-byte loads
// (vec: cols % 8 == 0, 16-byte aligned rows), else element loads, zero
// past `cols`
__device__ __forceinline__ void load8(const float* p, int64_t row, int cols,
                                     int c, bool vec, float (&f)[8]) {
  const float* r = p + row * cols + c;
  if (vec) {
    *reinterpret_cast<float4*>(f) = __ldg(reinterpret_cast<const float4*>(r));
    *reinterpret_cast<float4*>(f + 4) =
        __ldg(reinterpret_cast<const float4*>(r) + 1);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = c + e < cols ? __ldg(r + e) : 0.f;
}

__device__ __forceinline__ void load8(const bf16* p, int64_t row, int cols,
                                     int c, bool vec, float (&f)[8]) {
  const bf16* r = p + row * cols + c;
  if (vec) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(r)), f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = c + e < cols ? __bfloat162float(r[e]) : 0.f;
}

// rows [0, rows) of 64 channels of dy into a 128-byte-swizzled slab by
// element loads: row r holds frame f_first + r (zero outside [0, BT)),
// channels o0 .. o0 + 63 (zero past Co); thread `at` of `threads`
__device__ __forceinline__ void stage_dy_elem(uint32_t slab, const bf16* dy,
                                              int f_first, int rows, int o0,
                                              int BT, int Co, int at,
                                              int threads) {
  const uint16_t* d = reinterpret_cast<const uint16_t*>(dy);
  for (int e = at; e < rows * 8; e += threads) {
    const int r = e >> 3, j = e & 7, f = f_first + r, o = o0 + 8 * j;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (f >= 0 && f < BT) {
      const uint16_t* row = d + int64_t(f) * Co;
#pragma unroll
      for (int h = 0; h < 8; ++h)
        if (o + h < Co) v[h >> 1] |= uint32_t(row[o + h]) << (16 * (h & 1));
    }
    sts128(swz128(slab, r, j), make_uint4(v[0], v[1], v[2], v[3]));
  }
}

template <bool kTma, typename O>
__global__ void __launch_bounds__(kDgThreads, 2)
dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap dymap,
                   const bf16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ bsh, const bf16* __restrict__ dy,
                   O* __restrict__ dx, float* __restrict__ ws_da,
                   float* __restrict__ ws_db, bf16* __restrict__ planes,
                   int Tlen, int BT, int C, int Co, int Cop, int Cp,
                   int nslot) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kCols, tile = blockIdx.y, f0 = tile * kFrames;
  const int n = (Co + kOChunk - 1) / kOChunk;
  const int ns = min(n, kStages);   // the launch sized the ring for ns
  auto stage = [&](int s) { return base + s * kDgStageBytes; };
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[kStages + s]); };

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * kGroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 2 * kGroup / 32) {
    // producer: per chunk of 128 output channels, dy's halves (TMA route)
    // and the three taps' weights
    if (lane == 0) {
      prefetch_tensormap(&wmap);
      if (kTma) prefetch_tensormap(&dymap);
      for (int i = 0; i < n; ++i) {
        const int s = i % ns, o0 = i * kOChunk;
        const bool two = o0 + 64 < Co;   // the second half holds channels
        if (i >= ns) mbar_wait(empty(s), ((i / ns) - 1) & 1);
        mbar_arrive_expect_tx(
            full(s), 3 * kWTapBytes + (kTma ? (two ? 2 : 1) * kHaloBytes : 0));
        if (kTma) {
          tma_load_2d(stage(s), &dymap, full(s), o0, f0 - 1);
          if (two)
            tma_load_2d(stage(s) + kSlabBytes, &dymap, full(s), o0 + 64,
                        f0 - 1);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tma_load_2d(stage(s) + 2 * kSlabBytes + k * kWTapBytes, &wmap,
                      full(s), c0, k * Cop + o0);
      }
    }
    __syncwarp();
    return;
  }

  // consumer warpgroup cw: output channels [o0 + 64 cw, o0 + 64 cw + 64) of
  // each chunk, all 64 x 64 outputs of the tile
  const int cw = warp / 4, wq = warp % 4, g = lane >> 2, q = lane & 3;
  const int at = tid - cw * kGroup;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  // this thread's rows 16 wq + g (lo) and + 8 (hi): the tap at row offset
  // 0 reads frame f - 1, zero at a batch row's first frame; offset 2 reads
  // f + 1, zero at its last
  const int t_lo = (f0 + 16 * wq + g) % Tlen, t_hi = (f0 + 16 * wq + g + 8) % Tlen;
  const uint32_t keep0_lo = t_lo != 0 ? ~0u : 0u;
  const uint32_t keep0_hi = t_hi != 0 ? ~0u : 0u;
  const uint32_t keep2_lo = t_lo != Tlen - 1 ? ~0u : 0u;
  const uint32_t keep2_hi = t_hi != Tlen - 1 ? ~0u : 0u;
  // A fragments of one row offset; two buffers, so that one offset's
  // fragments load while the previous offset's products run
  uint32_t af[2][4][4];
  for (int i = 0; i < n; ++i) {
    const int s = i % ns, o0 = i * kOChunk;
    const bool live = o0 + 64 * cw < Co;
    const uint32_t slab = stage(s) + cw * kSlabBytes;
    if (!kTma && live) {
      named_barrier_sync(2 + cw, kGroup);   // the group is done with it
      stage_dy_elem(slab, dy, f0 - 1, kHalo, o0 + 64 * cw, BT, Co, at,
                    kGroup);
      named_barrier_sync(2 + cw, kGroup);
    }
    mbar_wait(full(s), (i / ns) & 1);
    if (live) {
      // row offset r pairs with tap 2 - r: dh[t] takes dy[t - k + 1] w_k
      auto offset = [&](int r, uint32_t(&a)[4][4], uint32_t keep_lo,
                        uint32_t keep_hi) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          ldsm_x4(a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                  swz128(slab, 16 * wq + r + (lane & 15),
                         2 * ks + (lane >> 4)));
          a[ks][0] &= keep_lo;
          a[ks][2] &= keep_lo;
          a[ks][1] &= keep_hi;
          a[ks][3] &= keep_hi;
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_mn<64>(
              acc, a[ks],
              wgmma_desc<128>(stage(s) + 2 * kSlabBytes +
                                  (2 - r) * kWTapBytes +
                                  (64 * cw + 16 * ks) * 128,
                              kWTapBytes, 1024));
        wgmma_commit();
      };
      offset(0, af[0], keep0_lo, keep0_hi);
      offset(1, af[1], ~0u, ~0u);
      wgmma_wait<1>();   // offset 0's products are done with af[0]
      offset(2, af[0], keep2_lo, keep2_hi);
      wgmma_wait<0>();
    }
    mbar_arrive(empty(s));
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) fence_operand(acc[e]);

  // every chunk is consumed (so every copy has landed): the stages' memory
  // takes the two halves' f32 tiles
  named_barrier_sync(1, 2 * kGroup);
  float* tiles = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* mine = tiles + cw * kEpiTileFloats;
#pragma unroll
  for (int jn = 0; jn < kCols / 8; ++jn) {
    const int row = 16 * wq + g, col = 8 * jn + 2 * q;
    *reinterpret_cast<float2*>(mine + row * kEpiStride + col) =
        make_float2(acc[4 * jn], acc[4 * jn + 1]);
    *reinterpret_cast<float2*>(mine + (row + 8) * kEpiStride + col) =
        make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
  }
  named_barrier_sync(1, 2 * kGroup);
  // dh = half 0 + half 1; dz, dx; h's two bf16 planes for wgrad; the
  // tiles then hold dz x and dz
  for (int e = tid; e < kFrames * (kCols / 8); e += 2 * kGroup) {
    const int row = e >> 3, grp = e & 7, f = f0 + row, c = c0 + 8 * grp;
    if (f >= BT || c >= C) continue;
    const int b = f / Tlen;
    float xv[8], av[8], bv[8], dxv[8], h0[8], h1[8];
    load8(x, f, C, c, kTma, xv);
    load8(a, b, C, c, kTma, av);
    load8(bsh, b, C, c, kTma, bv);
    float* p0 = tiles + row * kEpiStride + 8 * grp;
    float* p1 = p0 + kEpiTileFloats;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float z = affine(xv[j], av[j], bv[j]);
      const float sg = sigmoid(z);
      const float dz = (p0[j] + p1[j]) * (sg * (1.f + z * (1.f - sg)));
      const float h = c + j < C ? z * sg : 0.f;
      h0[j] = __bfloat162float(__float2bfloat16_rn(h));
      h1[j] = h - h0[j];   // exact in f32, rounded once more below
      dxv[j] = dz * av[j];
      p0[j] = dz * xv[j];
      p1[j] = dz;
    }
    bf16* hr = planes + int64_t(f) * Cp + c;   // Cp % 64 == 0: whole groups
    *reinterpret_cast<uint4*>(hr) = make_uint4(
        pack_bf16x2(h0[0], h0[1]), pack_bf16x2(h0[2], h0[3]),
        pack_bf16x2(h0[4], h0[5]), pack_bf16x2(h0[6], h0[7]));
    *reinterpret_cast<uint4*>(hr + int64_t(BT) * Cp) = make_uint4(
        pack_bf16x2(h1[0], h1[1]), pack_bf16x2(h1[2], h1[3]),
        pack_bf16x2(h1[4], h1[5]), pack_bf16x2(h1[6], h1[7]));
    O* dr = dx + int64_t(f) * C + c;
    if (kTma) {
      if constexpr (sizeof(O) == 2) {
        *reinterpret_cast<uint4*>(dr) = make_uint4(
            pack_bf16x2(dxv[0], dxv[1]), pack_bf16x2(dxv[2], dxv[3]),
            pack_bf16x2(dxv[4], dxv[5]), pack_bf16x2(dxv[6], dxv[7]));
      } else {
        reinterpret_cast<float4*>(dr)[0] =
            make_float4(dxv[0], dxv[1], dxv[2], dxv[3]);
        reinterpret_cast<float4*>(dr)[1] =
            make_float4(dxv[4], dxv[5], dxv[6], dxv[7]);
      }
    } else {
      for (int j = 0; j < 8 && c + j < C; ++j) dr[j] = from_f<O>(dxv[j]);
    }
  }
  named_barrier_sync(1, 2 * kGroup);
  // per column: the sums over the tile's rows of dz x (da) and dz (db), in
  // row order, one partial per batch row, at its slot tile - first tile
  if (tid < 2 * kCols) {
    const int which = tid / kCols, col = tid % kCols, c = c0 + col;
    if (c < C) {
      const float* src = tiles + which * kEpiTileFloats + col;
      float* dst = which ? ws_db : ws_da;
      const int rows = min(kFrames, BT - f0);
      int cur = f0 / Tlen, next = (cur + 1) * Tlen;
      float sum = 0.f;
      for (int i = 0; i < rows; ++i) {
        if (f0 + i == next) {
          dst[(int64_t(cur) * nslot + tile - int64_t(cur) * Tlen / kFrames) *
                  C + c] = sum;
          sum = 0.f;
          ++cur;
          next += Tlen;
        }
        sum += src[i * kEpiStride];
      }
      dst[(int64_t(cur) * nslot + tile - int64_t(cur) * Tlen / kFrames) * C +
          c] = sum;
    }
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap dymap,
                   const __grid_constant__ CUtensorMap hmap,
                   const bf16* __restrict__ dy, float* __restrict__ ws_dw,
                   float* __restrict__ ws_bias, int Tlen, int BT, int C,
                   int Co) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kWgStages];
  // per stage: the first and the last frame of a batch row among the
  // chunk's 64 frames, one bit each
  __shared__ uint64_t edges[kWgStages][2];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kCols, o0 = blockIdx.y * kWgRows;
  const int split = blockIdx.z, S = gridDim.z;
  const int nq = (BT + kFrames - 1) / kFrames;
  const int q_lo = int(int64_t(split) * nq / S);
  const int n = int(int64_t(split + 1) * nq / S) - q_lo;
  auto slab = [&](int s) { return base + s * kWgStageBytes; };
  auto plane = [&](int s, int p) {
    return slab(s) + kSlabBytes + p * kPanelBytes;
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
    // producer: per chunk of 64 frames, dy's frames [f0 - 1, f0 + 64] (TMA
    // route), h's two planes at [f0, f0 + 64), and the chunk's batch-row
    // edges
    if (lane == 0) {
      if (kTma) prefetch_tensormap(&dymap);
      prefetch_tensormap(&hmap);
      for (int i = 0; i < n; ++i) {
        const int s = i % kWgStages, f0 = (q_lo + i) * kFrames;
        if (i >= kWgStages) mbar_wait(empty(s), ((i / kWgStages) - 1) & 1);
        uint64_t first = 0, last = 0;
        for (int j = 0, t = f0 % Tlen; j < kFrames; ++j) {
          first |= uint64_t(t == 0) << j;
          last |= uint64_t(t == Tlen - 1) << j;
          t = t == Tlen - 1 ? 0 : t + 1;
        }
        edges[s][0] = first;
        edges[s][1] = last;
        mbar_arrive_expect_tx(
            full(s), (kTma ? kHaloBytes : 0) + kPlanes * kPanelBytes);
        if (kTma) tma_load_2d(slab(s), &dymap, full(s), o0, f0 - 1);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
          tma_load_3d(plane(s, p), &hmap, full(s), c0, f0, p);
      }
    }
    __syncwarp();
    return;
  }

  // consumer warpgroup k: tap k, A = dy transposed at the tap's row offset
  // (dy[f - k + 1] pairs with h[f]), B = the planes
  const int k = warp / 4, wq = warp % 4, g = lane >> 2, q = lane & 3;
  const bool with_bias = blockIdx.x == 0 && k == 1;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  float bias_lo = 0.f, bias_hi = 0.f;
  uint32_t af[4][4];
  for (int i = 0; i < n; ++i) {
    const int s = i % kWgStages, f0 = (q_lo + i) * kFrames;
    if (!kTma) {
      named_barrier_sync(1, 3 * kGroup);   // every tap is done with it
      stage_dy_elem(slab(s), dy, f0 - 1, kHalo, o0, BT, Co, tid,
                    3 * kGroup);
      named_barrier_sync(1, 3 * kGroup);
    }
    mbar_wait(full(s), (i / kWgStages) & 1);
    const int m = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4_trans(af[ks][0], af[ks][1], af[ks][2], af[ks][3],
                    swz128(slab(s), 16 * ks + (m >> 1) * 8 + (lane & 7) +
                                        2 - k,
                           2 * wq + (m & 1)));
    if (k != 1) {
      // tap 0 reads dy[f + 1]: zero at a batch row's last frame; tap 2
      // reads dy[f - 1]: zero at its first. Registers 0, 1 hold frames
      // 16 ks + 2q, + 1; registers 2, 3 the same + 8
      const uint64_t edge = edges[s][k == 0 ? 1 : 0];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 16 * ks + 2 * q + 8 * h;
          const uint32_t keep = ((edge >> f) & 1 ? 0u : 0xffffu) |
                                ((edge >> (f + 1)) & 1 ? 0u : 0xffff0000u);
          af[ks][2 * h] &= keep;
          af[ks][2 * h + 1] &= keep;
        }
    }
    if (with_bias) {
      // a0, a2: channel g at frames 2q, 2q + 1 (+ 8); a1, a3: g + 8
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float v[8];
        unpack8(make_uint4(af[ks][0], af[ks][2], af[ks][1], af[ks][3]), v);
        bias_lo += (v[0] + v[1]) + (v[2] + v[3]);
        bias_hi += (v[4] + v[5]) + (v[6] + v[7]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs_mn<64>(acc, af[ks],
                        wgmma_desc<128>(plane(s, p) + ks * 2048,
                                        kPanelBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(empty(s));
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) fence_operand(acc[e]);
  const bool pair = (C & 1) == 0;
#pragma unroll
  for (int jn = 0; jn < kCols / 8; ++jn) {
    const int c = c0 + 8 * jn + 2 * q;
    if (c >= C) continue;
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int o = o0 + 16 * wq + g + 8 * hrow;
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
    const int o = o0 + 16 * wq + g;
    if (q == 0 && o < Co) ws_bias[int64_t(split) * Co + o] = bias_lo;
    if (q == 0 && o + 8 < Co) ws_bias[int64_t(split) * Co + o + 8] = bias_hi;
  }
}

template <typename O>
__global__ void __launch_bounds__(256)
finalize_wgmma_kernel(const float* __restrict__ ws_dw,
                      const float* __restrict__ ws_bias,
                      const float* __restrict__ ws_da,
                      const float* __restrict__ ws_db, O* __restrict__ dw,
                      O* __restrict__ dbias, float* __restrict__ da,
                      float* __restrict__ db, int B, int Tlen, int C, int Co,
                      int S, int nslot) {
  int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  const int64_t n_w = int64_t(Co) * C;
  if (i < n_w) {
    for (int k = 0; k < 3; ++k) {
      float sum = 0.f;
      for (int s = 0; s < S; ++s) sum += ws_dw[(int64_t(s) * 3 + k) * n_w + i];
      dw[i * 3 + k] = from_f<O>(sum);
    }
    return;
  }
  i -= n_w;
  if (i < Co) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += ws_bias[int64_t(s) * Co + i];
    dbias[i] = from_f<O>(sum);
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

// the workspace's layout (f32 values): each split's dw and dbias partials,
// each batch row's da and db partials over its nslot frame-tile slots, then
// (at a multiple of 64 values) h's two bf16 planes (2, B T, Cp)
struct Workspace {
  float *dw, *bias, *da, *db;
  bf16* planes;
};

Workspace workspace(void* ws, int B, int Tlen, int C, int Co, int S,
                    int nslot) {
  Workspace w;
  w.dw = static_cast<float*>(ws);
  w.bias = w.dw + int64_t(S) * 3 * Co * C;
  w.da = w.bias + int64_t(S) * Co;
  w.db = w.da + int64_t(B) * nslot * C;
  const int64_t used = w.db + int64_t(B) * nslot * C - w.dw;
  w.planes = reinterpret_cast<bf16*>(w.dw + (used + 63) / 64 * 64);
  return w;
}

template <bool kTma, typename O>
cudaError_t launch(const CUtensorMap& wmap, const CUtensorMap& dymap,
                   const CUtensorMap& hmap, const Workspace& ws,
                   const void* x, const void* a, const void* b,
                   const void* dy, void* dx, void* da, void* db, void* dw,
                   void* dbias, int B, int Tlen, int C, int Co, int Cop,
                   int Cp, int S, int nslot, cudaStream_t st) {
  static bool dg_set[kMaxDevices] = {}, wg_set[kMaxDevices] = {};
  const int BT = B * Tlen;
  const int n = (Co + kOChunk - 1) / kOChunk;
  const size_t dg_smem =
      size_t(std::min(n, kStages)) * kDgStageBytes + 1024;
  cudaError_t err = allow_dynamic_smem(
      dgrad_wgmma_kernel<kTma, O>, int(kStages * kDgStageBytes + 1024), dg_set);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(wgrad_wgmma_kernel<kTma>, int(kWgSmemBytes),
                           wg_set);
  if (err != cudaSuccess) return err;
  const int n_ct = (C + kCols - 1) / kCols;
  const bf16* dyp = static_cast<const bf16*>(dy);
  dgrad_wgmma_kernel<kTma, O>
      <<<dim3(n_ct, (BT + kFrames - 1) / kFrames), kDgThreads, dg_smem, st>>>(
          wmap, dymap, static_cast<const bf16*>(x),
          static_cast<const float*>(a), static_cast<const float*>(b), dyp,
          static_cast<O*>(dx), ws.da, ws.db, ws.planes, Tlen, BT, C, Co, Cop,
          Cp, nslot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_wgmma_kernel<kTma>
      <<<dim3(n_ct, (Co + kWgRows - 1) / kWgRows, S), kWgThreads,
         kWgSmemBytes, st>>>(dymap, hmap, dyp, ws.dw, ws.bias, Tlen, BT, C,
                             Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = int64_t(Co) * C + Co + int64_t(B) * C;
  finalize_wgmma_kernel<O><<<unsigned((total + 255) / 256), 256, 0, st>>>(
      ws.dw, ws.bias, ws.da, ws.db, static_cast<O*>(dw),
      static_cast<O*>(dbias), static_cast<float*>(da),
      static_cast<float*>(db), B, Tlen, C, Co, S, nslot);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ns2vc

// x (B, T, C), dy (B, T, Co) bf16 contiguous; a, b (B, C) f32 contiguous;
// wmap the 128 bytes `ns2vc_encode_weight_map` wrote for the packed
// weights (3, Cop, Cp) of w (Co, C, 3), zero past (Co, C), Cp = C rounded
// up to 64. Writes dx (B, T, C), dw (Co, C, 3), dbias (Co,) in bf16, or in
// f32 (out_f32), and da, db (B, C) f32. ws: f32 workspace of
// ceil64(S * (3 * Co * C + Co) + 2 * B * nslot * C) + B * T * Cp values,
// nslot = (T + 62) / 64 + 1 (the 64-frame tiles of the flattened B * T
// frames a batch row can touch), 16-byte aligned; S (`splits`, 1 to
// ceil(B T / 64)) splits the weight gradient's frame sum. vec != 0: C % 8 ==
// 0, Co % 8 == 0 and x, dy, a, b 16-byte aligned (dy through a TMA map),
// else element loads. The caller guarantees B, T, C, Co >= 1 and
// ceil(B T / 64) <= 65535. Returns the CUDA error of the launches (0 on
// success), or a negative code from a tensor map.
extern "C" int ns2vc_affine_silu_conv1d_bwd_wgmma(
    const void* x, const void* a, const void* b, const void* wmap,
    const void* dy, void* dx, void* da, void* db, void* dw, void* dbias,
    void* ws, int B, int Tlen, int C, int Co, int Cop, int splits, int vec,
    int out_f32, void* stream) {
  using namespace ns2vc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BT = B * Tlen, Cp = (C + 63) / 64 * 64;
  const int nslot = (Tlen + kFrames - 2) / kFrames + 1;
  const Workspace w = workspace(ws, B, Tlen, C, Co, splits, nslot);
  CUtensorMap wm, dym = {}, hm;
  std::memcpy(&wm, wmap, sizeof wm);
  // h's planes (Cp, B T, 2): boxes of 64 channels x 64 frames x 1 plane
  const uint64_t hdims[3] = {uint64_t(Cp), uint64_t(BT), 2};
  const uint64_t hstrides[2] = {uint64_t(Cp) * 2, uint64_t(BT) * Cp * 2};
  const uint32_t hbox[3] = {64, uint32_t(kFrames), 1};
  int r = encode_bf16_map(&hm, w.planes, 3, hdims, hstrides, hbox);
  if (r == 0 && vec) {
    // dy (Co, B T): boxes of 64 channels x the 66 frames of a halo
    const uint64_t dims[2] = {uint64_t(Co), uint64_t(BT)};
    const uint64_t strides[1] = {uint64_t(Co) * 2};
    const uint32_t box[2] = {64, uint32_t(kHalo)};
    r = encode_bf16_map(&dym, dy, 2, dims, strides, box);
  }
  if (r != 0) return r;
  auto run = [&](auto tma, auto out) {
    using O = decltype(out);
    return int(launch<decltype(tma)::value, O>(
        wm, dym, hm, w, x, a, b, dy, dx, da, db, dw, dbias, B, Tlen, C, Co,
        Cop, Cp, splits, nslot, st));
  };
  using Vec = std::true_type;
  using Elem = std::false_type;
  if (vec) return out_f32 ? run(Vec(), 0.f) : run(Vec(), bf16());
  return out_f32 ? run(Elem(), 0.f) : run(Elem(), bf16());
}
