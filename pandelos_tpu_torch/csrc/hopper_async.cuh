// Shared by the join kernels: Hopper's bulk asynchronous copy with its
// mbarrier, and the phase timers of a -DPT_PROFILE build.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef PT_PROFILE
// cycles per phase, summed over warps; each kernel names its phases where
// it includes this header
__device__ unsigned long long g_profile[8];
#define PT_TICK(k)                          \
  {                                         \
    const long long now_ = clock64();       \
    prof_[k] += now_ - last_;               \
    last_ = now_;                           \
  }

// Copies the phase timers to `out` (8 values) and zeroes them.
extern "C" int pt_profile_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_profile, sizeof(unsigned long long) * 8);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_profile, zero, sizeof(zero));
  return (int)err;
}
#else
#define PT_TICK(k)
#endif

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(void* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(void* bar, int parity) {
  unsigned ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}
// One thread asks for `bytes` (a multiple of 16, both ends 16-byte
// aligned) to be copied from global to shared memory; the copy reports
// its bytes to the barrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace
