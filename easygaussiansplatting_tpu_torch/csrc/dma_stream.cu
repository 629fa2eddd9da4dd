// K10: chunked row sums at dynamic offsets, staged asynchronously.
//
// Replaces the Pallas kernel scripts/exp_dma_stream.py `kernel` (:25), a
// proving ground for streaming K-row chunks of an HBM array at runtime
// offsets: out[c] = sum over r < rows[c] of x[offs[c] + r, :], for x [m, 16]
// float32, with each [128, 16] block fetched by a double-buffered DMA one grid
// step ahead. Plain version: probes/exp_dma_stream.py::stream_sums_plain.
//
// What bounds it on an H100: bytes -- the distinct rows of x that the summed
// ranges cover (at most all of x, 16.8 MB at the script's m = 2^18), plus the
// offsets, the row counts and the output. Each chunk is only 8 KB at a
// data-dependent address, so latency, not bandwidth, sets the pace unless
// many copies are in flight.
//
// Design: Hopper's counterpart of the DMA with its semaphores, cp.async into
// two shared-memory slots (async_copy.cuh). A block walks CHUNKS consecutive
// chunks; it issues chunk c + 1's copy into the other slot before it waits for
// chunk c (the wait is one stage behind), then sums the first rows[c] rows
// column by column: 8 row groups of 16 column threads, the two groups of a
// warp joined by a shuffle, the four warps through shared memory, in a fixed
// order. Offsets and row counts are clamped into range, so no value can make
// the kernel read outside x; the plain version checks them and raises. TMA
// copies are later work.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int K = 128;          // rows of a chunk
constexpr int COLS = 16;        // columns of x
constexpr int THREADS = 128;
constexpr int GROUPS = THREADS / COLS;       // row groups of the column sum
constexpr int PIECES = K * COLS / 4;         // 16-byte pieces of a chunk
constexpr int CHUNKS = 8;                    // consecutive chunks per block

__device__ __forceinline__ void issue(float* slot, const float* __restrict__ x, long long m,
                                      const int* __restrict__ offs, int c) {
  const long long off = min(max((long long)offs[c], 0LL), m - K);
  const float* src = x + off * COLS;
#pragma unroll
  for (int j = 0; j < PIECES / THREADS; ++j) {
    const int i = j * THREADS + threadIdx.x;
    cp_async16(slot + 4 * i, src + 4 * i);
  }
}

__global__ void __launch_bounds__(THREADS)
stream_sums_kernel(const float* __restrict__ x, long long m, const int* __restrict__ offs,
                   const int* __restrict__ rows, int q, float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][K * COLS];
  __shared__ float part[THREADS / 32][COLS];
  const int c0 = blockIdx.x * CHUNKS;
  const int c1 = min(q, c0 + CHUNKS);
  const int col = threadIdx.x % COLS, grp = threadIdx.x / COLS;
  issue(buf[0], x, m, offs, c0);
  cp_async_commit();
  for (int c = c0; c < c1; ++c) {
    const int slot = (c - c0) & 1;
    if (c + 1 < c1) issue(buf[slot ^ 1], x, m, offs, c + 1);
    cp_async_commit();  // an empty group on the last chunk keeps the count
    cp_async_wait<1>();  // all groups but the newest have landed: chunk c
    __syncthreads();
    const int n = min(max(rows[c], 0), K);
    const float* b = buf[slot];
    float s = 0.f;
    for (int r = grp; r < n; r += GROUPS) s += b[r * COLS + col];
    s += __shfl_xor_sync(0xffffffffu, s, 16);  // the warp's two row groups
    if ((threadIdx.x & 31) < COLS) part[threadIdx.x >> 5][col] = s;
    // also orders this chunk's reads of buf[slot] before the next iteration's
    // copy into the other slot, and the one after into this one
    __syncthreads();
    if (threadIdx.x < COLS) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) t += part[w][col];
      out[(long long)c * COLS + col] = t;
    }
  }
}

}  // namespace

// x: [m, 16] device floats, m >= 128; offs, rows: [q] int32; out: [q, 16].
extern "C" int egs_stream_sums(const float* x, long long m, const int* offs, const int* rows,
                               int q, float* out, void* stream) {
  if (q <= 0) return 0;
  if (m < K) return (int)cudaErrorInvalidValue;
  const int blocks = (q + CHUNKS - 1) / CHUNKS;
  stream_sums_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, m, offs, rows, q, out);
  return (int)cudaGetLastError();
}
