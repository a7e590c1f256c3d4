// The resnet epilogue's backward on Hopper (sm_90a), for x in f32 (bf16
// takes affine_silu_conv1d_bwd_wgmma.cu), deterministic by construction:
// for
//     z = x a + b,  s = sigmoid(z),  h = z s,
//     y = conv1d_k3_SAME(h, w) + bias
// given dy (B, T, Co) it computes
//     dbias[o]     = sum_{b,t} dy[b,t,o]
//     dw[o,c,k]    = sum_{b,t} dy[b,t,o] h[b,t+k-1,c]      (zero past [0, T))
//     dh[b,t,c]    = sum_{k,o} dy[b,t-k+1,o] w[o,c,k]
//     dz = dh s (1 + z (1 - s)),  dx = dz a,
//     da[b,c] = sum_t dz x,  db[b,c] = sum_t dz.
// x (B, T, C), dy (B, T, Co) channels-last, w (Co, C, 3) torch Conv1d
// layout, a, b (B, C), all f32; so are dx, dw, dbias, da, db.
//
// Replaces: the backward of the port's kernel K2 (`_AffineSiluConv1dFn`
// in ops/fused_resnet.py), which handed the three shifted products to
// cuDNN's `convolution_backward`: its heuristics pick weight-gradient
// algorithms that sum in a different order from one run to the next, so
// two training steps from one state differed. The TPU kernel
// (ns2vc_tpu/ops/pallas_resnet.py::affine_silu_conv1d) is differentiated
// by XLA; this is the card's counterpart of that program.
//
// What bounds it on the H100: operations. Two products of 6 B T C Co FLOPs
// each (dh over K = 3 Co, dw over K = B T) on f32 inputs (x's activation
// is recomputed in f32), which the plain version, and the JAX reference,
// sum in f32.
// What the design does about it: the products run on the CUDA cores in
// f32 FFMA (exact products, f32 sums: at least the plain version's
// accuracy, which cuDNN runs in TF32 by default), in register tiles of 4 x
// 4 outputs per thread that take their three taps from one staging of the
// operands in shared memory: the frame halo of a tile is loaded once, not
// three times, and each 16-byte shared load feeds 12-16 FFMAs. Three
// kernels, no atomics:
//   - `dgrad`: one block per (batch, 64 frames, 64 input channels), an
//     implicit GEMM of dh over K = 3 Co in chunks of 16 output channels
//     (dy's frames [t0 - 1, t0 + 64] and w's three taps of the chunk, staged
//     through registers while the previous chunk computes). Its epilogue
//     recomputes z, s from x, a, b, writes dx and this tile's partial sums
//     of dz x and dz per channel (summed over the tile's rows in a fixed
//     order) into a workspace;
//   - `wgrad`: one block per (64 output channels, 64 input channels, split)
//     sums dw's three taps over the split's run of 16-frame chunks (a chunk
//     never crosses a batch row), activating x on the fly (frames outside
//     [0, T) are zero), and the blocks of the first input-channel tile sum
//     dbias alike; each split writes its partial sums;
//   - `finalize`: one thread per output element sums the splits' partials
//     of dw and dbias, and the frame tiles' partials of da and db, in index
//     order, and writes dw in (Co, C, 3) layout.
// Every sum runs in an order fixed by the indices alone, so two launches
// on one input give bitwise-equal outputs, whatever the card's schedule.
// The wrapper's `plan_backward` picks the splits: enough blocks for two per
// SM, at most 64 and at most the number of chunks, which keeps the
// workspace under ~13 MB at every width.
#include <cstdint>

namespace ns2vc {
namespace {

constexpr int kThreads = 256;           // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;               // dgrad: frames; wgrad: output channels
constexpr int kCols = 64;               // input channels per block
constexpr int kChunk = 16;              // dgrad: output channels per step;
                                        // wgrad: frames per chunk
constexpr int kHalo = kTile + 2;        // dgrad's staged frames t0-1..t0+64
constexpr int kHaloPad = kHalo + 2;     // rows of 16-byte multiples

// the kernels' element types (X, O) are f32: no conversion
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename O>
__device__ __forceinline__ O from_f(float v) { return v; }

// z = x a + b as the plain version rounds it (no contraction)
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

template <typename X, typename O>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const X* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ bsh, const X* __restrict__ w,
             const X* __restrict__ dy, O* __restrict__ dx,
             float* __restrict__ ws_da, float* __restrict__ ws_db, int Tlen,
             int C, int Co) {
  // dy transposed (output channel, frame), and w by (tap, output channel,
  // input channel); after the loop the second holds the row-sum reduction
  __shared__ __align__(16) float dys[kChunk][kHaloPad];
  __shared__ __align__(16) float wts[3][kChunk][kCols];
  static_assert(sizeof(wts) >= 2 * 16 * kCols * sizeof(float), "reduction");

  const int c0 = blockIdx.x * kCols, tt = blockIdx.y, b = blockIdx.z;
  const int t0 = tt * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = ty * 4, n0 = tx * 4;
  const X* dyb = dy + int64_t(b) * Tlen * Co;

  constexpr int kDyPer = (kChunk * kHalo + kThreads - 1) / kThreads;
  constexpr int kWPer = 3 * kChunk * kCols / kThreads;
  float rdy[kDyPer], rw[kWPer];

  auto load = [&](int o0) {
#pragma unroll
    for (int u = 0; u < kDyPer; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / kChunk, o = o0 + e % kChunk, t = t0 - 1 + r;
      rdy[u] = (e < kChunk * kHalo && t >= 0 && t < Tlen && o < Co)
                   ? to_f(dyb[int64_t(t) * Co + o])
                   : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWPer; ++u) {
      // 3 * kCols consecutive values of one output channel's row
      const int e = tid + u * kThreads;
      const int o = o0 + e / (3 * kCols), rem = e % (3 * kCols);
      rw[u] = (o < Co && c0 + rem / 3 < C)
                  ? to_f(w[(int64_t(o) * C + c0) * 3 + rem])
                  : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < kDyPer; ++u) {
      const int e = tid + u * kThreads;
      if (e < kChunk * kHalo) dys[e % kChunk][e / kChunk] = rdy[u];
    }
#pragma unroll
    for (int u = 0; u < kWPer; ++u) {
      const int e = tid + u * kThreads;
      const int rem = e % (3 * kCols);
      wts[rem % 3][e / (3 * kCols)][rem / 3] = rw[u];
    }
  };

  float acc[4][4] = {};
  const int n_chunks = (Co + kChunk - 1) / kChunk;
  load(0);
  store();
  __syncthreads();
  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) load((q + 1) * kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      // output row i0 + ii takes tap k from staged row i0 + ii - k + 2
      const float4 d4 = *reinterpret_cast<const float4*>(&dys[j][i0]);
      const float2 d2 = *reinterpret_cast<const float2*>(&dys[j][i0 + 4]);
      const float d[6] = {d4.x, d4.y, d4.z, d4.w, d2.x, d2.y};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(&wts[k][j][n0]);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
            acc[ii][nn] = fmaf(d[ii - k + 2], wv[nn], acc[ii][nn]);
      }
    }
    __syncthreads();
    if (q + 1 < n_chunks) {
      store();
      __syncthreads();
    }
  }

  // epilogue: dz, dx, and this tile's sums of dz x and dz per channel
  float pa[4] = {}, pb[4] = {};
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int t = t0 + i0 + ii;
    if (t >= Tlen) continue;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      const int c = c0 + n0 + nn;
      if (c >= C) continue;
      const int64_t at = (int64_t(b) * Tlen + t) * C + c;
      const float xv = to_f(x[at]);
      const float av = a[int64_t(b) * C + c];
      const float z = affine(xv, av, bsh[int64_t(b) * C + c]);
      const float s = sigmoid(z);
      const float dz = acc[ii][nn] * (s * (1.f + z * (1.f - s)));
      dx[at] = from_f<O>(dz * av);
      pa[nn] = fmaf(dz, xv, pa[nn]);
      pb[nn] += dz;
    }
  }
  float* red = &wts[0][0][0];   // [2][16 row groups][kCols]
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    red[ty * kCols + n0 + nn] = pa[nn];
    red[16 * kCols + ty * kCols + n0 + nn] = pb[nn];
  }
  __syncthreads();
  if (tid < 2 * kCols) {
    const int which = tid / kCols, n = tid % kCols, c = c0 + n;
    if (c < C) {
      float sum = 0.f;
      for (int r = 0; r < 16; ++r) sum += red[which * 16 * kCols + r * kCols + n];
      (which ? ws_db : ws_da)[(int64_t(b) * gridDim.y + tt) * C + c] = sum;
    }
  }
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const X* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ bsh, const X* __restrict__ dy,
             float* __restrict__ ws_dw, float* __restrict__ ws_bias, int B,
             int Tlen, int C, int Co) {
  __shared__ __align__(16) float dys[kChunk][kTile];      // frame, out ch.
  __shared__ __align__(16) float hs[kChunk + 2][kCols];   // frames t0-1..

  const int c0 = blockIdx.x * kCols, o0 = blockIdx.y * kTile;
  const int split = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = ty * 4, n0 = tx * 4;
  const int n_tc = (Tlen + kChunk - 1) / kChunk;
  const int total = B * n_tc;
  const int q_lo = int(int64_t(split) * total / S);
  const int q_hi = int(int64_t(split + 1) * total / S);

  constexpr int kDyPer = kChunk * kTile / kThreads;
  constexpr int kHN = (kChunk + 2) * kCols;
  constexpr int kHPer = (kHN + kThreads - 1) / kThreads;
  float rdy[kDyPer], rx[kHPer];

  auto load = [&](int q) {
    const int bb = q / n_tc, t0 = (q % n_tc) * kChunk;
#pragma unroll
    for (int u = 0; u < kDyPer; ++u) {
      const int e = tid + u * kThreads;
      const int t = t0 + e / kTile, o = o0 + e % kTile;
      rdy[u] = (t < Tlen && o < Co)
                   ? to_f(dy[(int64_t(bb) * Tlen + t) * Co + o])
                   : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kHPer; ++u) {
      const int e = tid + u * kThreads;
      const int t = t0 - 1 + e / kCols, c = c0 + e % kCols;
      rx[u] = (e < kHN && t >= 0 && t < Tlen && c < C)
                  ? to_f(x[(int64_t(bb) * Tlen + t) * C + c])
                  : 0.f;
    }
  };
  auto store = [&](int q) {
    const int bb = q / n_tc, t0 = (q % n_tc) * kChunk;
#pragma unroll
    for (int u = 0; u < kDyPer; ++u) {
      const int e = tid + u * kThreads;
      dys[e / kTile][e % kTile] = rdy[u];
    }
#pragma unroll
    for (int u = 0; u < kHPer; ++u) {
      const int e = tid + u * kThreads;
      if (e >= kHN) continue;
      const int t = t0 - 1 + e / kCols, c = c0 + e % kCols;
      float h = 0.f;   // SAME padding: h is zero outside the frames
      if (t >= 0 && t < Tlen && c < C) {
        const int64_t bc = int64_t(bb) * C + c;
        const float z = affine(rx[u], a[bc], bsh[bc]);
        h = z * sigmoid(z);
      }
      hs[e / kCols][e % kCols] = h;
    }
  };

  float acc[3][4][4] = {};
  float bacc[4] = {};
  if (q_lo < q_hi) {
    load(q_lo);
    store(q_lo);
  }
  __syncthreads();
  for (int q = q_lo; q < q_hi; ++q) {
    if (q + 1 < q_hi) load(q + 1);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      // frame j pairs dy's row j with h's rows j + k (tap k)
      const float4 d4 = *reinterpret_cast<const float4*>(&dys[j][m0]);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) bacc[mm] += d[mm];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 h4 = *reinterpret_cast<const float4*>(&hs[j + k][n0]);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
            acc[k][mm][nn] = fmaf(d[mm], hv[nn], acc[k][mm][nn]);
      }
    }
    __syncthreads();
    if (q + 1 < q_hi) {
      store(q + 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int o = o0 + m0 + mm;
      if (o >= Co) continue;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int c = c0 + n0 + nn;
        if (c < C)
          ws_dw[((int64_t(split) * 3 + k) * Co + o) * C + c] = acc[k][mm][nn];
      }
    }
  if (blockIdx.x == 0 && tx == 0) {
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int o = o0 + m0 + mm;
      if (o < Co) ws_bias[int64_t(split) * Co + o] = bacc[mm];
    }
  }
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ ws_dw,
                const float* __restrict__ ws_bias,
                const float* __restrict__ ws_da,
                const float* __restrict__ ws_db, O* __restrict__ dw,
                O* __restrict__ dbias, float* __restrict__ da,
                float* __restrict__ db, int B, int C, int Co, int S,
                int n_tt) {
  int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
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
    float sa = 0.f, sb = 0.f;
    for (int tt = 0; tt < n_tt; ++tt) {
      sa += ws_da[(bb * n_tt + tt) * C + c];
      sb += ws_db[(bb * n_tt + tt) * C + c];
    }
    da[i] = sa;
    db[i] = sb;
  }
}

template <typename X, typename O>
int launch(const void* x, const void* a, const void* b, const void* w,
           const void* dy, void* dx, void* da, void* db, void* dw,
           void* dbias, void* ws, int B, int Tlen, int C, int Co, int S,
           cudaStream_t st) {
  const int n_tt = (Tlen + kTile - 1) / kTile;
  const int n_ct = (C + kCols - 1) / kCols;
  float* ws_dw = static_cast<float*>(ws);
  float* ws_bias = ws_dw + int64_t(S) * 3 * Co * C;
  float* ws_da = ws_bias + int64_t(S) * Co;
  float* ws_db = ws_da + int64_t(B) * n_tt * C;
  const X* xp = static_cast<const X*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const X* dyp = static_cast<const X*>(dy);
  dgrad_kernel<X, O><<<dim3(n_ct, n_tt, B), kThreads, 0, st>>>(
      xp, ap, bp, static_cast<const X*>(w), dyp, static_cast<O*>(dx), ws_da,
      ws_db, Tlen, C, Co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  wgrad_kernel<X><<<dim3(n_ct, (Co + kTile - 1) / kTile, S), kThreads, 0,
                    st>>>(xp, ap, bp, dyp, ws_dw, ws_bias, B, Tlen, C, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t n = int64_t(Co) * C + Co + int64_t(B) * C;
  finalize_kernel<O><<<unsigned((n + kThreads - 1) / kThreads), kThreads, 0,
                       st>>>(ws_dw, ws_bias, ws_da, ws_db,
                             static_cast<O*>(dw), static_cast<O*>(dbias),
                             static_cast<float*>(da), static_cast<float*>(db),
                             B, C, Co, S, n_tt);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ns2vc

// x (B, T, C), w (Co, C, 3), dy (B, T, Co) contiguous f32; a, b (B, C)
// f32 contiguous. Writes dx (B, T, C), dw (Co, C, 3), dbias (Co,), da, db
// (B, C), all f32. ws: f32 workspace of S * 3 * Co * C + S * Co + 2 * B *
// ceil(T / 64) * C values; S (`splits`) >= 1 splits the weight gradient's
// sum over the B * ceil(T / 16) frame chunks (at most that many). The
// caller guarantees B >= 1, T >= 1, C >= 1, Co >= 1 and B, ceil(T / 64) <=
// 65535. Returns the CUDA error of the launches (0 on success).
extern "C" int ns2vc_affine_silu_conv1d_bwd(
    const void* x, const void* a, const void* b, const void* w,
    const void* dy, void* dx, void* da, void* db, void* dw, void* dbias,
    void* ws, int B, int Tlen, int C, int Co, int splits, void* stream) {
  return ns2vc::launch<float, float>(x, a, b, w, dy, dx, da, db, dw, dbias,
                                     ws, B, Tlen, C, Co, splits,
                                     static_cast<cudaStream_t>(stream));
}
