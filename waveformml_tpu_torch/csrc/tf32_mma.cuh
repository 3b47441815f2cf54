// TF32 tensor-core products at fp32 accuracy and cp.async staging, shared
// by the row-conv kernels (row_conv.cu, row_conv_wgrad.cu).
//
// A product is taken in three m16n8k8 TF32 passes of each operand split
// into a big and a small TF32 part (small·big + big·small + big·big), which
// drops only the small·small term, ~2^-22 relative: fp32 accuracy on the
// tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// x rounded to the nearest TF32 (10 mantissa bits), as the bits of a float:
// add half a TF32 ulp to the magnitude and clear the 13 low bits (cheaper
// than cvt.rna.tf32.f32, with the same result except on ties)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a · b on one m16n8k8 tile (A row-major 16x8, B column-major 8x8)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `vec` floats (4, 8 or 16 bytes) from global to shared memory, or
// zero-fill them when `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid, int vec) {
  const uint32_t d = smem_addr(dst);
  const int bytes = valid ? vec * 4 : 0;
  if (vec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  } else if (vec == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
