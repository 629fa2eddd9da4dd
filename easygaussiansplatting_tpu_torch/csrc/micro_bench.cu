// K9: the grid-overhead probes of scripts/micro_bench.py, on the card.
//
// Replaces the three Pallas kernels of scripts/micro_bench.py, each a
// sequential grid over the q chunks of `packed` [16, q*256] (one [16, 256]
// chunk per grid step, one tile's 256 pixels):
//   variant_a             (:41)  streams every chunk through VMEM and writes
//                                an [8, 128] block of zeros: the cost of the
//                                input pipeline alone;
//   variant_b             (:61)  adds rows 0-2 of each chunk into the output
//                                block of its tile (revisited output blocks);
//   variant_vmem_resident (:93)  sums rows 0-2 of each chunk over its pixels
//                                into a resident [n_tiles, 3] scratch.
// Plain versions: probes/micro_bench.py::variant_{a,b,vmem_resident}_plain.
//
// What bounds them on an H100: bytes. A reads all of `packed` (102.7 MB at
// the script's q = 6,266, twice the 50 MB L2); B and V read rows 0-2 only
// (19.25 MB) and B writes [n_tiles, 3, 256] plus tau [n_tiles, 256].
//
// Designs. The TPU grid runs in order on one core; here blocks run in no
// order on 132 SMs, so nothing may carry from one block to the next.
//   A: one block per chunk copies its 16 KB into shared memory with cp.async
//      (async_copy.cuh: volatile PTX, so the loads that nothing reads stay);
//      block 0 writes the zeros.
//   B, V: the K4 shape, one block per tile and one thread per pixel. A block
//      finds its chunk range in the non-decreasing `tiles` by binary search
//      and sums its chunks in index order, so a tile that no chunk visits
//      comes out zero (B's TPU output is undefined there: it initialises only
//      tiles[0]'s block) and every sum is deterministic, with no atomics. V
//      then reduces the 256 pixels by warp shuffles and shared memory.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int ROWS = 16;     // rows of `packed`
constexpr int K = 256;       // columns of a chunk: one tile's pixels
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// A: stream chunk blockIdx.x, [16, 256] floats = 1,024 16-byte pieces, 4 a
// thread; piece i is row i / 64, columns 4 * (i % 64) .. +3.
__global__ void __launch_bounds__(THREADS)
stream_chunks_kernel(const float* __restrict__ packed, long long ld,
                     float* __restrict__ out, int out_n) {
  __shared__ __align__(16) float stage[ROWS * K];
  const long long col0 = (long long)blockIdx.x * K;
#pragma unroll
  for (int j = 0; j < ROWS * K / 4 / THREADS; ++j) {
    const int i = j * THREADS + threadIdx.x;
    const int r = i / (K / 4), c = 4 * (i % (K / 4));
    cp_async16(&stage[r * K + c], packed + r * ld + col0 + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < out_n; i += THREADS) out[i] = 0.f;
  }
}

// the first chunk whose tile is >= t in the non-decreasing tiles[0..q); any
// value order keeps the result in [0, q]
__device__ __forceinline__ int lower_bound(const int* __restrict__ tiles, int q, int t) {
  int lo = 0, hi = q;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tiles[mid] < t) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// B (RESIDENT false) and V (true): block t sums its chunks' rows 0-2.
template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
tile_sums_kernel(const float* __restrict__ packed, long long ld,
                 const int* __restrict__ tiles, int q, float* __restrict__ img,
                 float* __restrict__ tau, float* __restrict__ out) {
  __shared__ int range[2];
  __shared__ float part[3][WARPS];
  const int t = blockIdx.x, p = threadIdx.x;
  if (p < 2) range[p] = lower_bound(tiles, q, t + p);
  __syncthreads();
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int c = range[0]; c < range[1]; ++c) {
    const long long col = (long long)c * K + p;
    a0 += packed[col];
    a1 += packed[ld + col];
    a2 += packed[2 * ld + col];
  }
  if (!RESIDENT) {
    float* dst = img + (long long)t * 3 * K + p;
    dst[0] = a0;
    dst[K] = a1;
    dst[2 * K] = a2;
    tau[(long long)t * K + p] = 1.f;
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    if ((p & 31) == 0) {
      part[0][p >> 5] = a0;
      part[1][p >> 5] = a1;
      part[2][p >> 5] = a2;
    }
    __syncthreads();
    if (p < 3) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[p][w];
      out[(long long)t * 3 + p] = s;
    }
  }
}

}  // namespace

// packed: [16, ld] device floats with ld = q * 256; out: out_n floats.
extern "C" int egs_stream_chunks(const float* packed, long long ld, int q, float* out,
                                 int out_n, void* stream) {
  if (q <= 0) return 0;
  stream_chunks_kernel<<<q, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, ld, out, out_n);
  return (int)cudaGetLastError();
}

// packed: [16, ld], ld = q * 256; tiles: [q] int32. resident = 0 writes img
// [n_tiles, 3, 256] and tau [n_tiles, 256]; resident = 1 writes out
// [n_tiles, 3].
extern "C" int egs_tile_sums(const float* packed, long long ld, const int* tiles, int q,
                             int n_tiles, float* img, float* tau, float* out, int resident,
                             void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident) {
    tile_sums_kernel<true><<<n_tiles, THREADS, 0, s>>>(packed, ld, tiles, q, img, tau, out);
  } else {
    tile_sums_kernel<false><<<n_tiles, THREADS, 0, s>>>(packed, ld, tiles, q, img, tau, out);
  }
  return (int)cudaGetLastError();
}
