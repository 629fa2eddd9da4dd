// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared by
// the K9 and K10 probes (micro_bench.cu, dma_stream.cu).
//
// Each copy moves 16 bytes and bypasses L1 (.cg). Copies issued by a thread
// since its last commit form one group; cp_async_wait<N>() returns once at most
// N of the thread's groups are still in flight. A __syncthreads() after the
// wait makes every thread's landed copies visible to the block.
//
// The PTX is volatile and clobbers memory, so the compiler keeps every copy
// even where nothing reads the staged data (K9a streams without reading).

#pragma once

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
