// Warp-level tensor-core and asynchronous-copy helpers (inline PTX) for the
// kernels: cp.async of 16 bytes with zero fill, ldmatrix (plain and
// transposed), mma.sync m16n8k16 bf16 x bf16 -> f32, and mma.sync m16n8k8
// TF32 x TF32 -> f32 with the 3xTF32 split that the f32 kernels use.
//
// Fragment layouts of mma.m16n8k16 (lane l, g = l / 4, c = 2 * (l % 4)):
//   A (16 x 16, row-major), 4 regs of 2 x bf16:
//     a0 (g, c..c+1)  a1 (g+8, c..c+1)  a2 (g, c+8..c+9)  a3 (g+8, c+8..c+9)
//   B (16 x 8, k-major per column), 2 regs: b0 (k c..c+1, n g), b1 (k c+8..c+9, n g)
//   C (16 x 8, f32), 4 regs: c0 c1 (g, c..c+1)  c2 c3 (g+8, c..c+1)
// Fragment layouts of mma.m16n8k8 .tf32 (lane l, g = l / 4, t = l % 4):
//   A (16 x 8, row-major), 4 regs: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8), 2 regs: b0 (k t, n g)  b1 (k t+4, n g)
//   C (16 x 8, f32): as m16n8k16's
// ldmatrix (non-transposed) of 8 rows of four 32-bit values gives lane l the
// value at (row g, column t): an A or B fragment of the TF32 product.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace ns2vc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; copies `bytes` (0 or 16) and zero-fills the
// rest, so an out-of-range chunk becomes zeros without a branch on the copy.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a . b on the tensor cores, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> TF32 (8-bit exponent, 10 stored mantissa bits), rounded to nearest
// with ties away from zero, as a 32-bit pattern whose low 13 bits are zero
// (the mask makes that explicit: mma reads only the upper 19 bits)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// 3xTF32: x = big + small + O(2^-22 |x|), both halves TF32. big is x
// rounded to TF32; x - big is exact in f32, and small is it rounded again.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a . b on the tensor cores, TF32 inputs, f32 accumulators
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b to about f32 accuracy from the operands' big and small halves:
// small.big + big.small + big.big, the small terms first; small.small
// (~2^-22 of the product) is dropped. Each TF32 product is exact in f32.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32_1688(d, as, bb0, bb1);
  mma_tf32_1688(d, ab, bs0, bs1);
  mma_tf32_1688(d, ab, bb0, bb1);
}

// two f32 -> one register of 2 x bf16 (round to nearest even), lo in the
// low half, as the fragments above order their columns
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace ns2vc
