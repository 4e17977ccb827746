// Device helpers shared by the port's CUDA kernels: asynchronous 16-byte
// copies from device memory into shared memory (cp.async, sm_80 and later),
// float32 -> element conversion, and division by a runtime constant without
// an integer divide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coclr {

// One 16-byte copy from global to shared memory, bypassing L1 (.cg): the
// data is read once. Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Waits for every cp.async this thread issued; a __syncthreads() after it
// makes all threads' copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// n / d and n % d for 0 <= n < 2^31 and a divisor fixed at launch: one
// multiply-high and a shift (the round-up method of CUTLASS's FastDivmod).
struct FastDiv {
  unsigned d, mul, shr;

  FastDiv() = default;
  __host__ explicit FastDiv(unsigned divisor) : d(divisor), mul(0), shr(0) {
    if (d > 1) {
      unsigned l = 0;
      while ((1u << l) < d) ++l;  // ceil(log2 d)
      const unsigned p = 31 + l;
      mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
      shr = p - 32;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), mul) >> shr);
  }
  __device__ __forceinline__ int divmod(int n, int& rem) const {
    const int q = div(n);
    rem = n - q * static_cast<int>(d);
    return q;
  }
};

}  // namespace coclr
