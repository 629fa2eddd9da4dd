// Hopper's bulk copies (the Tensor Memory Accelerator, TMA) and the shared
// memory barriers (mbarrier) that report their completion, sm_90 and later.
// Used by K10 (dma_stream.cu).
//
// A bulk copy moves a contiguous run of bytes from global to shared memory:
// one thread issues it, the hardware computes the addresses and, when the
// bytes have landed, counts them off the transaction count of an mbarrier in
// shared memory. A barrier's phase completes once its pending arrivals and
// its pending transaction bytes are both zero; waiters poll the phase's
// parity bit, which flips at each completion.
//
// The pattern (a ring of slots, one "full" barrier a slot, initialised with
// an arrival count of 1):
//   producer:  mbar_arrive_expect_tx(full, bytes); bulk_copy_g2s(slot, src,
//              bytes, full);   -- or mbar_arrive(full) when there is nothing
//              to copy: a copy of 0 bytes is never issued;
//   consumers: mbar_wait(full, parity), then read the slot.
// The phase of the k-th use of a slot is k & 1. Before a slot is refilled,
// every read of it by the generic proxy (ordinary loads) must be ordered
// before the async proxy's write: the consumers pass a barrier (a
// __syncwarp where one warp reads the slot, as in K10; a __syncthreads or
// an "empty" mbarrier where several do) and the producer then issues
// fence_proxy_async() before the copy.
//
// What the card tests cover: K10's one reader warp a slot with a __syncwarp
// as the empty side, and two uses a slot (phases 0 and 1; dma_stream.cu
// asserts it). The empty side of several reader warps a slot (an "empty"
// mbarrier or a __syncthreads) and a parity that wraps past a slot's second
// use are not run by any test: the first kernel that needs them (K4/K5 with
// staged table rows) brings a card test that does.
//
// Each helper is volatile inline PTX that clobbers memory, so the compiler
// neither drops nor reorders it across other memory accesses.
// Addresses: shared memory by its 32-bit shared-window address
// (__cvta_generic_to_shared), global memory by its generic 64-bit address.

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises the barrier with `count` expected arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After the inits and before any other thread (or the TMA unit) uses the
// barriers: makes the inits visible to the async proxy. A __syncthreads()
// after it publishes them to the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrive once and add `bytes` to the phase's pending transaction count: the
// phase then completes when the copies that name this barrier have landed
// exactly `bytes`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive once with no transaction (release semantics at CTA scope).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// One poll: true once the phase with this parity has completed (acquire
// semantics at CTA scope, so the landed bytes are visible to the caller).
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Orders this thread's earlier generic-proxy accesses of shared memory (and
// those of every thread it has synchronised with) before its later
// async-proxy operations: issued by the producer before a copy refills a
// slot that consumers have read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` (a non-zero multiple of 16) from global `src` to shared `dst`,
// both 16-byte aligned; the landed bytes are counted off `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
