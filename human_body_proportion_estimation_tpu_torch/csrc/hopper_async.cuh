// Hopper (sm_90) asynchronous-copy primitives shared by the kernels of this
// directory: shared-memory barriers (mbarrier) and the bulk copy engine's
// contiguous global -> shared copy, which reports its bytes to a barrier.
// Thin inline-PTX wrappers, no state.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace hbpe {

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the last mbar_init, by the initializing thread, before the
// __syncthreads() that publishes the barriers: makes them visible to the
// other threads and to the copy engine.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before a later
// asynchronous copy into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of copies to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase differs from `parity` (a fresh barrier is
// in phase 0, so waiting with parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
  // the loop stays inside the asm block: control flow the compiler cannot
  // see cannot make it serialize wgmmas that are in flight around the wait
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra WAIT_DONE;\n"
      "bra WAIT_LOOP;\n"
      "WAIT_DONE:\n"
      "}\n"
      :
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

// One contiguous global -> shared copy (16-byte aligned both ends, size a
// multiple of 16) whose bytes are counted by `bar`. One thread starts it.
__device__ __forceinline__ void bulk_load(void *dst, const void *src,
                                          uint32_t bytes, uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace hbpe
