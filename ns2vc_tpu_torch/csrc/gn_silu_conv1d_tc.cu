// Fused resnet epilogue on Hopper's tensor cores (sm_90a), bf16:
//     y = conv1d_k3_SAME(silu(x * a + b), w) + bias
// with a per-(batch, channel) f32 affine a, b (B, C); x (B, T, C) and
// y (B, T, Co) channels-last.
//
// Replaces: ns2vc_tpu/ops/pallas_resnet.py::affine_silu_conv1d (the Pallas
// TPU kernel `_kernel`) for bf16 inputs; f32 calls stay on
// gn_silu_conv1d.cu.
//
// What bounds it on the H100: an implicit GEMM of M = frames, N = Co,
// K = 3 C, 2 B T C Co 3 FLOPs over x and w read once: at the UNet's widths
// (C, Co of 128..1024) it is compute-bound on the bf16 tensor cores, with
// device memory close behind (71 GFLOP and ~0.2 GB per B=16 step); at
// B <= 2 the output tiles alone fill a few of the 132 SMs.
// What the design does about it: one block of 4 warps (2 x 2, 32 x 32 each)
// per (64-frame, 64-channel) output tile walks the input channels in chunks
// of 32. Per chunk, the frames [t0-1, t0+64] of x and the matching slab of
// the weights are copied to shared memory with 16-byte cp.async, double
// buffered so the next chunk's copy overlaps this chunk's math. Each thread
// then applies the f32 affine, the SiLU and the zero padding outside
// [0, T) to the 16-byte pieces it copied, in place, and stores them as bf16
// (the bf16 model's precision; the TPU's default f32 matmul is also one
// bf16 pass; the SiLU uses the fast exponential and division, whose error
// is far below that rounding). The three taps are three mma.sync m16n8k16
// passes over the same staged tile at row offsets 0, 1, 2: ldmatrix takes
// one address per
// row, so the halo costs no copy. The weights come packed once per module
// by the wrapper as (3, Co_pad, C_pad) bf16, contiguous along C and zero
// padded to the tile, so their copies need no bounds. Rows are padded by 16
// bytes in shared memory: ldmatrix reads are free of bank conflicts. For
// small grids (B <= 2, the deep levels) the wrapper's planner splits the
// channel loop over blockIdx.z; each split writes f32 partial sums to a
// workspace and a second kernel adds them, adds the bias and rounds to
// bf16. When C is not a multiple of 8 (or x is not 16-byte aligned) the
// caller passes vec = 0 and x is staged with element loads. Later work:
// wgmma, TMA, warp specialisation, the GroupNorm statistics in a kernel.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace ns2vc {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // frames per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 32;        // input channels per chunk
constexpr int kThreads = 128;  // 4 warps, 2 x 2
constexpr int kRows = kBM + 2; // staged frames t0-1 .. t0+64
constexpr int kS = kBK + 8;    // shared row stride (bf16), +16 bytes

__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

__global__ void __launch_bounds__(kThreads)
affine_silu_conv_k3_tc_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ bsh,
                              const bf16* __restrict__ wp,
                              const bf16* __restrict__ bias,
                              bf16* __restrict__ y, float* __restrict__ ws,
                              int Tlen, int C, int Co, int Cp, int Cop,
                              int chunks_per_split, int splits, int vec) {
  __shared__ __align__(16) bf16 Xs[2][kRows][kS];
  __shared__ __align__(16) bf16 Ws[2][3][kBN][kS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int t0 = blockIdx.x * kBM, co0 = blockIdx.y * kBN;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int n_chunks = Cp / kBK;
  const int ch_begin = split * chunks_per_split;
  const int ch_end = min(n_chunks, ch_begin + chunks_per_split);
  const bf16* xb = x + int64_t(b) * Tlen * C;
  const float* ab = a + int64_t(b) * C;
  const float* bb = bsh + int64_t(b) * C;

  auto load = [&](int ch, int buf) {
    const int c0 = ch * kBK;
    if (vec) {
      for (int e = tid; e < kRows * (kBK / 8); e += kThreads) {
        const int r = e / (kBK / 8), c = c0 + (e % (kBK / 8)) * 8;
        const int t = t0 - 1 + r;
        const bool in = t >= 0 && t < Tlen && c < C;
        cp_async_16(smem_u32(&Xs[buf][r][c - c0]),
                    in ? xb + int64_t(t) * C + c : x, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kRows * kBK; e += kThreads) {
        const int r = e / kBK, c = c0 + e % kBK, t = t0 - 1 + r;
        Xs[buf][r][c - c0] = (t >= 0 && t < Tlen && c < C)
                                 ? xb[int64_t(t) * C + c]
                                 : __float2bfloat16(0.f);
      }
    }
    for (int e = tid; e < 3 * kBN * (kBK / 8); e += kThreads) {
      const int kk = e / (kBN * (kBK / 8)), rem = e % (kBN * (kBK / 8));
      const int n = rem / (kBK / 8), c = (rem % (kBK / 8)) * 8;
      cp_async_16(smem_u32(&Ws[buf][kk][n][c]),
                  wp + (int64_t(kk) * Cop + co0 + n) * Cp + c0 + c, 16);
    }
  };

  // silu(x * a + b) in place on the pieces this thread copied; zeros
  // outside [0, T) and past C (the conv's SAME padding)
  auto activate = [&](int ch, int buf) {
    const int c0 = ch * kBK;
    if (vec) {
      for (int e = tid; e < kRows * (kBK / 8); e += kThreads) {
        const int r = e / (kBK / 8), c = c0 + (e % (kBK / 8)) * 8;
        const int t = t0 - 1 + r;
        uint4* p = reinterpret_cast<uint4*>(&Xs[buf][r][c - c0]);
        if (t < 0 || t >= Tlen || c >= C) {
          *p = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
        uint4 raw = *p;
        uint32_t* w32 = reinterpret_cast<uint32_t*>(&raw);
        // a, b for these 8 channels: two 16-byte loads each (vec: 16-byte
        // aligned rows of a multiple of 8 channels)
        float av[8], bv[8];
        const float4* a4 = reinterpret_cast<const float4*>(ab + c);
        const float4* b4 = reinterpret_cast<const float4*>(bb + c);
        *reinterpret_cast<float4*>(av) = __ldg(a4);
        *reinterpret_cast<float4*>(av + 4) = __ldg(a4 + 1);
        *reinterpret_cast<float4*>(bv) = __ldg(b4);
        *reinterpret_cast<float4*>(bv + 4) = __ldg(b4 + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 pr = *reinterpret_cast<__nv_bfloat162*>(&w32[i]);
          w32[i] = pack_bf16x2(
              silu(fmaf(__bfloat162float(pr.x), av[2 * i], bv[2 * i])),
              silu(fmaf(__bfloat162float(pr.y), av[2 * i + 1], bv[2 * i + 1])));
        }
        *p = raw;
      }
    } else {
      for (int e = tid; e < kRows * kBK; e += kThreads) {
        const int r = e / kBK, c = c0 + e % kBK, t = t0 - 1 + r;
        bf16& val = Xs[buf][r][c - c0];
        val = (t >= 0 && t < Tlen && c < C)
                  ? __float2bfloat16(silu(fmaf(__bfloat162float(val),
                                               __ldg(ab + c), __ldg(bb + c))))
                  : __float2bfloat16(0.f);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (ch_begin < ch_end) {
    load(ch_begin, 0);
    cp_async_commit();
  }
  for (int ch = ch_begin, i = 0; ch < ch_end; ++ch, ++i) {
    const int buf = i & 1;
    if (ch + 1 < ch_end) {
      load(ch + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    activate(ch, buf);  // this thread's own copies have landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                  smem_u32(&Xs[buf][wm * 32 + mi * 16 + kk + (lane & 15)]
                                [ks * 16 + (lane >> 4) * 8]));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(b0, b1, b2, b3,
                  smem_u32(&Ws[buf][kk][wn * 32 + np * 16 + ((lane >> 4) << 3) +
                                        (lane & 7)]
                                [ks * 16 + (((lane >> 3) & 1) << 3)]));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16_16816(acc[mi][2 * np], af[mi], b0, b1);
            mma_bf16_16816(acc[mi][2 * np + 1], af[mi], b2, b3);
          }
        }
      }
    }
    __syncthreads();  // this chunk's buffers are free for chunk + 2
  }

  const int64_t n_out = int64_t(gridDim.z / splits) * Tlen * Co;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int co = co0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (co >= Co) continue;
      const bool pair = co + 1 < Co;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * half;
        if (t >= Tlen) continue;
        const int64_t idx = (int64_t(b) * Tlen + t) * Co + co;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (splits > 1) {
          float* wz = ws + split * n_out + idx;
          wz[0] = v0;
          if (pair) wz[1] = v1;
        } else if (pair && (Co & 1) == 0) {
          *reinterpret_cast<uint32_t*>(y + idx) =
              pack_bf16x2(v0 + __bfloat162float(bias[co]),
                          v1 + __bfloat162float(bias[co + 1]));
        } else {
          y[idx] = __float2bfloat16(v0 + __bfloat162float(bias[co]));
          if (pair) y[idx + 1] = __float2bfloat16(v1 + __bfloat162float(bias[co + 1]));
        }
      }
    }
  }
}

// y = bf16(bias + sum of the splits' f32 partial sums)
__global__ void split_k_reduce_kernel(const float* __restrict__ ws,
                                      const bf16* __restrict__ bias,
                                      bf16* __restrict__ y, int64_t n, int Co,
                                      int splits) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float s = __bfloat162float(bias[i % Co]);
    for (int z = 0; z < splits; ++z) s += ws[z * n + i];
    y[i] = __float2bfloat16(s);
  }
}

}  // namespace
}  // namespace ns2vc

// x (B, T, C), y (B, T, Co), bias (Co,): bf16 contiguous; a, b (B, C) f32
// contiguous; wp the packed weights (3, Cop, Cp) bf16, Cp a multiple of 32
// and Cop of 64, zero past (Co, C); ws (splits, B, T, Co) f32 when
// splits > 1, else null. Split z takes the 32-channel chunks
// [z * chunks_per_split, (z + 1) * chunks_per_split). The caller guarantees
// B * splits <= 65535, T, C, Co >= 1, and, when vec != 0, C % 8 == 0 and x,
// a and b 16-byte aligned. Returns the CUDA error of the launches (0 on success).
extern "C" int ns2vc_affine_silu_conv1d_tc(const void* x, const void* a,
                                           const void* b, const void* wp,
                                           const void* bias, void* y, void* ws,
                                           int B, int Tlen, int C, int Co,
                                           int Cp, int Cop,
                                           int chunks_per_split, int splits,
                                           int vec, void* stream) {
  using ns2vc::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Tlen + ns2vc::kBM - 1) / ns2vc::kBM, Cop / ns2vc::kBN, B * splits);
  ns2vc::affine_silu_conv_k3_tc_kernel<<<grid, ns2vc::kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y),
      static_cast<float*>(ws), Tlen, C, Co, Cp, Cop, chunks_per_split, splits,
      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  const int64_t n = int64_t(B) * Tlen * Co;
  const int blocks = int((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ns2vc::split_k_reduce_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(bias),
      static_cast<bf16*>(y), n, Co, splits);
  return int(cudaGetLastError());
}
