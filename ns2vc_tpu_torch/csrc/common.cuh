// Shared helpers for the port's hand-written kernels: dtype codes and
// f32 <-> storage-type conversion. Every kernel computes in f32 and only
// loads/stores in the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ns2vc {

// dtype codes passed from Python (ops/_build.py keeps the same table)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared memory limit to `bytes` once per device
// (the attribute is per device): `done` is the calling launcher's own
// static table, so later launches, and launches under CUDA graph capture,
// make no runtime call for it.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                               bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace ns2vc
