// Fused resnet epilogue on Hopper's tensor cores (sm_90a), bf16:
//     y = conv1d_k3_SAME(silu(x * a + b), w) + bias
// with a per-(batch, channel) f32 affine a, b (B, C) (group_norm_affine.cu
// folds it); x (B, T, C) and y (B, T, Co) channels-last.
//
// Replaces: ns2vc_tpu/ops/pallas_resnet.py::affine_silu_conv1d (the Pallas
// TPU kernel `_kernel`) for bf16 inputs; f32 calls go to gn_silu_conv1d.cu.
//
// What bounds it on the H100: operations. An implicit GEMM of M = frames,
// N = Co, K = 3 C: 2 B T C Co 3 FLOPs over x and w read once; at the UNet's
// widths (C, Co of 128..1024; 71 GFLOP and ~0.2 GB per B=16 step) the bf16
// tensor cores bound it, and only wgmma reaches their full rate. At B <= 2
// and at the deep levels the output tiles alone fill few of the 132 SMs.
// What the design does about it: one block per (64-frame, 128-channel)
// output tile, warp specialised into three roles over a ring of 3
// shared-memory stages, each holding a 64-channel chunk of the input:
//   - a producer warp: one thread keeps TMA copies in flight, per chunk the
//     frames [t0 - 1, t0 + 64] of x (a 3-D (B, T, C) map; TMA fills frames
//     and channels out of range with zeros) on the stage's `xfull` mbarrier
//     and the weights' three taps (128 Co rows of 128 bytes each, from a
//     2-D tensor map over the packed (3 * Co_pad, C_pad) weights, 128-byte
//     swizzle) on its `wfull` one; it reuses a stage when the consumers
//     release it;
//   - an activating warpgroup: as soon as a chunk of x lands it applies
//     the f32 affine, the SiLU (fast
//     exponential and division, far inside the bf16 rounding that follows)
//     and the SAME padding (frames outside [0, T) and channels past C
//     become zeros: silu(b) is not zero) to it in place, once per block and
//     chunk, while its weights still arrive and the consumers multiply the
//     previous chunk;
//   - two consumer warpgroups, each taking every other chunk into its own
//     f32 accumulators: wgmma m64n128k16, bf16 -> f32 in registers, A from
//     registers (ldmatrix of the activated slab at row offsets 0, 1, 2 for
//     the three taps: the halo costs no copy, and a shared-memory A
//     descriptor shifted by one row would break the swizzle atom), B from
//     the swizzled weights through a descriptor. A chunk's 12 products go
//     in two commit groups (taps 0 and 1, then tap 2), each waited for
//     before the next fragments load (ptxas serialises wgmma whose register
//     inputs are written while products are in flight), so the tensor
//     cores run one warpgroup's products while the other loads fragments.
// The 128-wide tile feeds each activated slab to twice the output channels
// of the mma.sync design it replaced (64), so the SiLU runs half as often
// per output. The
// 416 threads (13 warps, up to 4 on one of the SM's 4 schedulers, whose
// register files are separate) leave each thread 128 registers: 64
// accumulators and 32 of A fragments fit unspilled.
// Epilogue: both warpgroups' accumulators go through shared memory (f32)
// and are added there; y is stored in whole rows: bias, round to bf16,
// 16-byte stores. Grids
// that underfill the card split the channel loop (the wrapper's
// `plan_wgmma`): the splits of one tile form a thread block cluster, and
// after each has written its partial tile, every block adds the cluster's
// partials for its share of the rows through distributed shared memory, in
// order of rank (deterministic, no atomics, no workspace and no second
// kernel). When TMA cannot describe x (C % 8 != 0, or x, a, b not 16-byte
// aligned) the caller passes vec = 0: the activating warpgroup loads x
// element by element from global memory into the same swizzled layout
// (sub-route "tc_elem"); the weights still come by TMA.
// Launched with programmatic dependent launch (kPdl, hopper.cuh) where
// the caller says the kernel just before it writes none of the packed
// weights (pdl != 0: after the statistics kernel, group_norm_affine.cu,
// with the weights packed before that): a block may start while that
// kernel merges and folds, initialises its barriers and issues its first
// stages' weight copies, and reads a, b, x and the bias only after
// `grid_dependency_wait`. Without the attribute it waits for the kernel
// before it as any launch does.
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                  // frames per block
constexpr int kBN = 128;                 // output channels per block
constexpr int kBK = 64;                  // input channels per chunk
constexpr int kStages = 3;
constexpr int kRows = kBM + 2;           // staged frames t0-1 .. t0+64
constexpr int kXBoxBytes = kRows * 128;  // what the x copy delivers
constexpr int kXBytes = 9 * 1024;        // its slot, 1024-byte aligned
constexpr int kWTapBytes = kBN * 128;
constexpr int kWBytes = 3 * kWTapBytes;
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kGroup = 128;              // threads of a warpgroup
constexpr int kConsumers = 2 * kGroup, kActivators = kGroup;
constexpr int kThreads = kConsumers + kActivators + 32;   // + the producer
constexpr int kOutStride = kBN + 8;      // f32 epilogue tile row (floats)
constexpr int kTileBytes = kBM * kOutStride * 4;
constexpr size_t kSmemBytes = size_t(kStages) * kStageBytes + 1024;
static_assert(2 * kTileBytes <= kStages * kStageBytes, "epilogue tiles");

__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

template <bool kTmaX>
__global__ void __launch_bounds__(kThreads, 1)
affine_silu_conv_k3_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                                 const __grid_constant__ CUtensorMap xmap,
                                 const bf16* __restrict__ x,
                                 const float* __restrict__ a,
                                 const float* __restrict__ bsh,
                                 const bf16* __restrict__ bias,
                                 bf16* __restrict__ y, int Tlen, int C,
                                 int Co, int Cop, int chunks_per_split,
                                 int splits) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 * kStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * kBM, co0 = blockIdx.y * kBN;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int n_chunks = (C + kBK - 1) / kBK;
  const int ch_begin = split * chunks_per_split;
  const int n = min(n_chunks, ch_begin + chunks_per_split) - ch_begin;
  auto stage = [&](int s) { return base + s * kStageBytes; };
  auto xfull = [&](int s) { return smem_u32(&bars[s]); };
  auto wfull = [&](int s) { return smem_u32(&bars[kStages + s]); };
  auto xready = [&](int s) { return smem_u32(&bars[2 * kStages + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[3 * kStages + s]); };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(xfull(s), 1);
      mbar_init(wfull(s), 1);
      mbar_init(xready(s), kActivators);
      mbar_init(empty(s), kGroup);   // the warpgroup that took the chunk
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == (kConsumers + kActivators) / 32) {
    // producer: TMA copies of each chunk's x and weights. Without the x
    // map (tc_elem) the x barrier still completes once the stage is free.
    if (lane == 0) {
      prefetch_tensormap(&wmap);
      if (kTmaX) prefetch_tensormap(&xmap);
      // the first stages' weights before the wait: the kernel before
      // this one does not write them (pdl; x, a and b come from the
      // kernels before it: after the wait)
      const int pre = min(n, kStages);
      for (int i = 0; i < pre; ++i) {
        const int s = i, c0 = (ch_begin + i) * kBK;
        mbar_arrive_expect_tx(wfull(s), kWBytes);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tma_load_2d(stage(s) + kXBytes + k * kWTapBytes, &wmap, wfull(s),
                      c0, k * Cop + co0);
      }
      if constexpr (kPdl) grid_dependency_wait();
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages, c0 = (ch_begin + i) * kBK;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        mbar_arrive_expect_tx(xfull(s), kTmaX ? kXBoxBytes : 0);
        if (kTmaX) tma_load_3d(stage(s), &xmap, xfull(s), c0, t0 - 1, b);
        if (i >= pre) {
          mbar_arrive_expect_tx(wfull(s), kWBytes);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            tma_load_2d(stage(s) + kXBytes + k * kWTapBytes, &wmap, wfull(s),
                        c0, k * Cop + co0);
        }
      }
    }
    __syncwarp();
  } else if (warp >= kConsumers / 32) {
    // activation: silu(x * a + b) in place, zeros outside [0, T) and past C
    const int at = tid - kConsumers, j = at & 7;
    if constexpr (kPdl) grid_dependency_wait();   // a, b and x
    const float* ab = a + int64_t(b) * C;
    const float* bb = bsh + int64_t(b) * C;
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages, c = (ch_begin + i) * kBK + j * 8;
      mbar_wait(xfull(s), (i / kStages) & 1);
      float av[8], bv[8];
      if (kTmaX) {
        // whole 8-channel groups: C % 8 == 0
        if (c < C) {
          const float4* a4 = reinterpret_cast<const float4*>(ab + c);
          const float4* b4 = reinterpret_cast<const float4*>(bb + c);
          *reinterpret_cast<float4*>(av) = __ldg(a4);
          *reinterpret_cast<float4*>(av + 4) = __ldg(a4 + 1);
          *reinterpret_cast<float4*>(bv) = __ldg(b4);
          *reinterpret_cast<float4*>(bv + 4) = __ldg(b4 + 1);
        }
        for (int r = at >> 3; r < kRows; r += kActivators / 8) {
          const int t = t0 - 1 + r;
          const uint32_t addr = swz128(stage(s), r, j);
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (c < C && t >= 0 && t < Tlen) {
            v = lds128(addr);
            uint32_t* w32 = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 p =
                  *reinterpret_cast<__nv_bfloat162*>(&w32[e]);
              w32[e] = pack_bf16x2(
                  silu(fmaf(__bfloat162float(p.x), av[2 * e], bv[2 * e])),
                  silu(fmaf(__bfloat162float(p.y), av[2 * e + 1],
                            bv[2 * e + 1])));
            }
          }
          sts128(addr, v);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          av[e] = c + e < C ? __ldg(ab + c + e) : 0.f;
          bv[e] = c + e < C ? __ldg(bb + c + e) : 0.f;
        }
        for (int r = at >> 3; r < kRows; r += kActivators / 8) {
          const int t = t0 - 1 + r;
          const bool in = t >= 0 && t < Tlen;
          const bf16* xr = x + (int64_t(b) * Tlen + (in ? t : 0)) * C;
          float h[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            h[e] = in && c + e < C
                       ? silu(fmaf(__bfloat162float(xr[c + e]), av[e], bv[e]))
                       : 0.f;
          sts128(swz128(stage(s), r, j),
                 make_uint4(pack_bf16x2(h[0], h[1]), pack_bf16x2(h[2], h[3]),
                            pack_bf16x2(h[4], h[5]), pack_bf16x2(h[6], h[7])));
        }
      }
      fence_proxy_async();   // before a later TMA copy into this stage
      mbar_arrive(xready(s));
    }
  } else {
    // consumer warpgroup cw takes chunks cw, cw + 2, ...: wgmma over the
    // activated slab and the swizzled weights
    const int cw = warp / 4, wq = warp % 4;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    uint32_t af[8][4];
    // taps [k0, k0 + taps) of stage s: their fragments, then their products
    auto taps_mma = [&](int s, int k0, auto taps) {
#pragma unroll
      for (int k = 0; k < decltype(taps)::value; ++k)
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          ldsm_x4(af[k * 4 + ks][0], af[k * 4 + ks][1], af[k * 4 + ks][2],
                  af[k * 4 + ks][3],
                  swz128(stage(s), 16 * wq + k0 + k + (lane & 15),
                         2 * ks + (lane >> 4)));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < decltype(taps)::value; ++k)
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          wgmma_m64n128k16_rs(
              acc, af[k * 4 + ks],
              wgmma_desc<128>(stage(s) + kXBytes + (k0 + k) * kWTapBytes +
                                  ks * 32,
                              16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
    };
    for (int i = cw; i < n; i += 2) {
      const int s = i % kStages;
      const uint32_t par = (i / kStages) & 1;
      mbar_wait(wfull(s), par);
      mbar_wait(xready(s), par);
      taps_mma(s, 0, std::integral_constant<int, 2>());
      taps_mma(s, 2, std::integral_constant<int, 1>());
      mbar_arrive(empty(s));
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) fence_operand(acc[e]);
    // both warpgroups are done with every stage (and so are the copies and
    // the activation they waited for): the stages' memory takes the tiles
    named_barrier_sync(1, kConsumers);
    float* tile = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                           cw * kTileBytes);
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn) {
      const int row = 16 * wq + g, col = 8 * jn + 2 * q;
      *reinterpret_cast<float2*>(tile + row * kOutStride + col) =
          make_float2(acc[4 * jn], acc[4 * jn + 1]);
      *reinterpret_cast<float2*>(tile + (row + 8) * kOutStride + col) =
          make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
    // the second warpgroup's partial into the first's tile (it holds one
    // when the split has two chunks or more), so a cluster's peers read
    // one tile per block
    if (chunks_per_split > 1) {
      named_barrier_sync(1, kConsumers);
      float* t0p = reinterpret_cast<float*>(smem_raw + (base - raw));
      for (int e = tid; e < kBM * (kBN / 4); e += kConsumers) {
        const int off = (e / (kBN / 4)) * kOutStride + (e % (kBN / 4)) * 4;
        float4 p = *reinterpret_cast<float4*>(t0p + off);
        const float4 q = *reinterpret_cast<const float4*>(
            t0p + kTileBytes / 4 + off);
        p.x += q.x;
        p.y += q.y;
        p.z += q.z;
        p.w += q.w;
        *reinterpret_cast<float4*>(t0p + off) = p;
      }
    }
  }

  // every split's partial tile is in its block's shared memory
  if (splits > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  if (tid < kConsumers) {
    const uint32_t rank = splits > 1 ? cluster_ctarank() : 0;
    const int rb = int(rank) * kBM / splits;
    const int re = int(rank + 1) * kBM / splits;
    const bool whole = (Co & 7) == 0;
    for (int e = tid; e < (re - rb) * (kBN / 8); e += kConsumers) {
      const int row = rb + e / (kBN / 8), col = (e % (kBN / 8)) * 8;
      const int t = t0 + row, co = co0 + col;
      if (t >= Tlen || co >= Co) continue;
      const uint32_t addr = base + uint32_t(row * kOutStride + col) * 4;
      // the splits' partials in a fixed order: rank 0's, rank 1's, ...
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < splits; ++r) {
        float4 lo, hi;
        if (splits > 1) {
          const uint32_t p = map_to_rank(addr, r);
          lo = ld_cluster_f32x4(p);
          hi = ld_cluster_f32x4(p + 16);
        } else {
          const float* tp = reinterpret_cast<const float*>(
              smem_raw + (addr - raw));
          lo = *reinterpret_cast<const float4*>(tp);
          hi = *reinterpret_cast<const float4*>(tp + 4);
        }
        const float pv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += pv[k];
      }
      bf16* yr = y + (int64_t(b) * Tlen + t) * Co + co;
      if (whole) {
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[k] = pack_bf16x2(v[2 * k] + __bfloat162float(bias[co + 2 * k]),
                             v[2 * k + 1] +
                                 __bfloat162float(bias[co + 2 * k + 1]));
        *reinterpret_cast<uint4*>(yr) = make_uint4(o[0], o[1], o[2], o[3]);
      } else {
        for (int k = 0; k < 8 && co + k < Co; ++k)
          yr[k] = __float2bfloat16(v[k] + __bfloat162float(bias[co + k]));
      }
    }
  }
  if (splits > 1) cluster_sync();   // the peers have read this block's tile
}

template <bool kTmaX>
cudaError_t launch(const CUtensorMap& wmap, const CUtensorMap& xmap,
                   const void* x, const void* a, const void* b,
                   const void* bias, void* y, int B, int Tlen, int C, int Co,
                   int Cop, int chunks_per_split, int splits, int pdl,
                   cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(
      affine_silu_conv_k3_wgmma_kernel<kTmaX>, int(kSmemBytes), smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Tlen + kBM - 1) / kBM, Cop / kBN, B * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  attr[1] = pdl_attribute();   // may start while the statistics finish
  cfg.attrs = attr;
  cfg.numAttrs = kPdl && pdl ? 2 : 1;
  err = cudaLaunchKernelEx(
      &cfg, affine_silu_conv_k3_wgmma_kernel<kTmaX>, wmap, xmap,
      static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(bias),
      static_cast<bf16*>(y), Tlen, C, Co, Cop, chunks_per_split, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace ns2vc

// The tensor map of packed weights wp (rows = 3 * Cop, cols = Cp) bf16
// contiguous, Cop a multiple of 128 and Cp of 64, into the 128 bytes at
// map_out: boxes of 64 channels x 128 rows, 128-byte swizzle. Returns 0, or
// a negative code (-1: libcuda's encoder was not found; -(1000 + r): it
// returned CUresult r).
extern "C" int ns2vc_encode_weight_map(const void* wp, int rows, int cols,
                                       void* map_out) {
  CUtensorMap map;
  const uint64_t dims[2] = {uint64_t(cols), uint64_t(rows)};
  const uint64_t strides[1] = {uint64_t(cols) * 2};
  const uint32_t box[2] = {ns2vc::kBK, ns2vc::kBN};
  const int r = ns2vc::encode_bf16_map(&map, wp, 2, dims, strides, box);
  if (r == 0) std::memcpy(map_out, &map, sizeof map);
  return r;
}

// x (B, T, C), y (B, T, Co), bias (Co,): bf16 contiguous; a, b (B, C) f32
// contiguous; wmap the 128 bytes `ns2vc_encode_weight_map` wrote for the
// packed weights (3, Cop, Cp), zero past (Co, C). Split z of a tile takes
// the 64-channel chunks [z * chunks_per_split, (z + 1) * chunks_per_split);
// splits (1..8) is the cluster size. vec != 0: C % 8 == 0 and x, a, b
// 16-byte aligned (x through a TMA map), else element loads. The caller
// guarantees B * splits <= 65535 and T, C, Co >= 1. pdl != 0: launched
// programmatically (the kernel before it writes none of the packed
// weights). Returns the CUDA error of the launch (0 on success), or a
// negative code from the map of x.
extern "C" int ns2vc_affine_silu_conv1d_tc(const void* x, const void* a,
                                           const void* b, const void* wmap,
                                           const void* bias, void* y, int B,
                                           int Tlen, int C, int Co, int Cop,
                                           int chunks_per_split, int splits,
                                           int vec, int pdl, void* stream) {
  using namespace ns2vc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap w, xm;
  std::memcpy(&w, wmap, sizeof w);
  if (!vec) {
    return int(launch<false>(w, w, x, a, b, bias, y, B, Tlen, C, Co, Cop,
                             chunks_per_split, splits, pdl, st));
  }
  const uint64_t dims[3] = {uint64_t(C), uint64_t(Tlen), uint64_t(B)};
  const uint64_t strides[2] = {uint64_t(C) * 2, uint64_t(Tlen) * C * 2};
  const uint32_t box[3] = {kBK, kRows, 1};
  const int r = encode_bf16_map(&xm, x, 3, dims, strides, box);
  if (r != 0) return r;
  return int(launch<true>(w, xm, x, a, b, bias, y, B, Tlen, C, Co, Cop,
                          chunks_per_split, splits, pdl, st));
}
