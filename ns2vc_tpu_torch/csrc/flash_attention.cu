// Flash attention forward for Hopper (sm_90a), f32 or bf16 in, same dtype out.
//
// Replaces: ns2vc_tpu/ops/pallas_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`). Same function: softmax(q.k^T * scale +
// key_bias) . v with an online softmax over key tiles, running max / sum /
// accumulator in f32, and the row sum floored at 1e-30 so a row whose keys
// are all masked stays finite.
//
// What bounds it on the H100: at the model's shapes (head dim 4..100,
// T <= ~450 keys) the FLOPs are small; the kernel is bound by shared-memory
// traffic of its f32 CUDA-core inner products and, for the short UNet
// levels, by how few blocks there are (Tq/64 * B*H).
// What the design does about it: one block per (64-query tile, batch*head)
// walks all key tiles in a loop (the TPU kernel's sequential grid axis
// becomes that loop), so the (Tq, Tk) score matrix never reaches device
// memory. Q/K rows are stored in shared memory with an odd row stride so
// the column reads of the score product are bank-conflict free; each of the
// 256 threads owns a 4x4 block of scores and a 4 x (DP/16) block of the
// output accumulator in registers. The head dim is padded to a template
// width DP in {16, 32, 64, 128} with zero-filled, bounds-checked loads.
// q/k/v/o are read and written through (batch, head, seq) strides with a
// unit stride on the head dim, so the caller passes the (B, T, H*D)
// projections without a transpose copy. Tensor-core MMA, TMA and warp
// specialisation are later work.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace ns2vc {
namespace {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;

template <int DP>
constexpr size_t flash_smem_bytes() {
  // Qs + Ks (stride DP+1), Vs (stride DP), Ss (stride BK+1), m/l/alpha rows
  return sizeof(float) * (size_t(kBQ) * (DP + 1) + size_t(kBK) * (DP + 1) +
                          size_t(kBK) * DP + size_t(kBQ) * (kBK + 1) + 3 * kBQ);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, int H, int Tq, int Tk, int D,
                 int64_t q_sb, int64_t q_sh, int64_t q_st,
                 int64_t k_sb, int64_t k_sh, int64_t k_st,
                 int64_t v_sb, int64_t v_sh, int64_t v_st,
                 int64_t o_sb, int64_t o_sh, int64_t o_st, float scale) {
  constexpr int QS = DP + 1;
  constexpr int SS = kBK + 1;
  constexpr int DJ = DP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ss = Vs + kBK * DP;
  float* row_m = Ss + kBQ * SS;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  T* ob = o + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + int64_t(b) * Tk : nullptr;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, d = e % DP, t = q0 + r;
    Qs[r * QS + d] = (t < Tq && d < D) ? to_f32(qb[t * q_st + d]) : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -1e30f;
    row_l[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // last tile's readers are done (and Q/rows are visible)
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, d = e % DP, t = k0 + r;
      const bool in = t < Tk && d < D;
      Ks[r * QS + d] = in ? to_f32(kb[t * k_st + d]) : 0.f;
      Vs[r * DP + d] = in ? to_f32(vb[t * v_st + d]) : 0.f;
    }
    __syncthreads();

    // scores: S[r][c] = q_r . k_c * scale + bias_c; keys past Tk are marked -inf
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, key = k0 + c;
      const float bj = (key < Tk && biasb) ? biasb[key] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ss[(ty + 16 * i) * SS + c] = key < Tk ? s[i][j] * scale + bj : -CUDART_INF_F;
    }
    __syncthreads();

    // online softmax: four threads per query row
    {
      const int r = tid >> 2, lane = tid & 3;
      float* srow = Ss + r * SS;
      float mx = -CUDART_INF_F;
      for (int c = lane; c < kBK; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: m_old starts at -1e30
      float sum = 0.f;
      for (int c = lane; c < kBK; c += 4) {
        const float sv = srow[c];
        const float p = sv == -CUDART_INF_F ? 0.f : expf(sv - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[t * o_st + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, int B, int H, int Tq, int Tk,
                   int D, const int64_t* s, float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), H, Tq, Tk, D,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_width(const void* q, const void* k, const void* v,
                           const float* bias, void* o, int B, int H, int Tq,
                           int Tk, int D, const int64_t* s, float scale,
                           cudaStream_t stream) {
  if (D <= 16) return launch<T, 16>(q, k, v, bias, o, B, H, Tq, Tk, D, s, scale, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, bias, o, B, H, Tq, Tk, D, s, scale, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, bias, o, B, H, Tq, Tk, D, s, scale, stream);
  return launch<T, 128>(q, k, v, bias, o, B, H, Tq, Tk, D, s, scale, stream);
}

}  // namespace
}  // namespace ns2vc

// q/k/v/o are (B, H, T, D) views given by element strides (batch, head,
// seq) with unit stride on D; bias is (B, Tk) f32 contiguous or null.
// The caller guarantees 1 <= D <= 128, Tq >= 1, Tk >= 1, B*H <= 65535.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ns2vc_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int dtype, int B, int H, int Tq, int Tk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, float scale, void* stream) {
  const int64_t s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                         v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ns2vc::kFloat32)
    return ns2vc::dispatch_width<float>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, st);
  if (dtype == ns2vc::kBFloat16)
    return ns2vc::dispatch_width<__nv_bfloat16>(q, k, v, bf, o, B, H, Tq, Tk, D, s, scale, st);
  return int(cudaErrorInvalidValue);
}
