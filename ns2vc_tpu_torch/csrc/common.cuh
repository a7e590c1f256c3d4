// Shared host-side helper of the port's hand-written kernels: raising a
// kernel's dynamic shared memory limit once per device.
#pragma once

#include <cuda_runtime.h>

namespace ns2vc {

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
