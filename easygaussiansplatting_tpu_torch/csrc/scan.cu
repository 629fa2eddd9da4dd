// K3: multi-row inclusive cumulative sum (int32 or float32, up to 8 rows).
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/scan.py
// `_scan_kernel` (reached through `multi_cumsum` and `batched_cumsum`), which
// walks lane blocks in order on the TPU's one core and carries a running
// total in VMEM scratch. Plain version: torch.cumsum along axis 1 with the
// input's dtype kept (ops/kernels/scan.py::multi_cumsum_plain).
//
// What bounds it on an H100: bytes — one read and one write of 4 bytes per
// element, against one add. Blocks run in no order on 132 SMs, so the carry
// becomes a reduce-then-scan: (1) every block of TILE elements writes its sum,
// (2) one block per row turns those sums into exclusive block offsets,
// (3) every block scans its TILE elements again and adds its offset. The
// input is read twice (the second read mostly from the 50 MB L2 at binning's
// sizes). Any length is accepted; int32 results are exact (two's-complement
// wrap, as in torch). A single pass with decoupled look-back is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // elements per block
constexpr int WARPS = THREADS / 32;

// Inclusive scan of one value per thread across a THREADS-wide block.
// Returns the thread's inclusive prefix; *total receives the block total.
template <typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* total) {
  __shared__ T warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < WARPS ? warp_sums[lane] : T(0);
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      T up = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += up;
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

// (1) per-block sums: grid (n_blocks, rows)
template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_block_sums(const T* __restrict__ x, T* __restrict__ sums, long long m,
                int n_blocks) {
  const int row = blockIdx.y;
  const long long base = (long long)blockIdx.x * TILE;
  const T* xr = x + (long long)row * m;
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long idx = base + (long long)i * THREADS + threadIdx.x;
    if (idx < m) acc += xr[idx];
  }
  T total;
  block_inclusive_scan(acc, &total);
  if (threadIdx.x == 0) sums[(long long)row * n_blocks + blockIdx.x] = total;
}

// (2) exclusive scan of the block sums, in place: grid (rows)
template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_block_offsets(T* __restrict__ sums, int n_blocks) {
  T* s = sums + (long long)blockIdx.x * n_blocks;
  T carry = T(0);
  for (int b0 = 0; b0 < n_blocks; b0 += THREADS) {
    const int b = b0 + threadIdx.x;
    const T v = b < n_blocks ? s[b] : T(0);
    T total;
    const T inc = block_inclusive_scan(v, &total);
    if (b < n_blocks) s[b] = carry + (inc - v);
    carry += total;
  }
}

// (3) scan each block and add its offset: grid (n_blocks, rows). Thread t owns
// the ITEMS consecutive elements base + t*ITEMS .. +ITEMS-1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_apply(const T* __restrict__ x, T* __restrict__ y,
           const T* __restrict__ offsets, long long m, int n_blocks) {
  const int row = blockIdx.y;
  const long long first = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  const T* xr = x + (long long)row * m;
  T* yr = y + (long long)row * m;
  T local[ITEMS];
  T run = T(0);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long idx = first + i;
    run += idx < m ? xr[idx] : T(0);
    local[i] = run;
  }
  T total;
  const T inc = block_inclusive_scan(run, &total);
  const T prefix = offsets[(long long)row * n_blocks + blockIdx.x] + (inc - run);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long idx = first + i;
    if (idx < m) yr[idx] = prefix + local[i];
  }
}

template <typename T>
int multi_cumsum(const T* x, T* y, T* sums, int rows, long long m, int n_blocks,
                 void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  if (n_blocks != (int)((m + TILE - 1) / TILE)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_blocks, rows);
  scan_block_sums<T><<<grid, THREADS, 0, s>>>(x, sums, m, n_blocks);
  scan_block_offsets<T><<<rows, THREADS, 0, s>>>(sums, n_blocks);
  scan_apply<T><<<grid, THREADS, 0, s>>>(x, y, sums, m, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows, m] contiguous device arrays; sums: [rows, n_blocks] device
// scratch with n_blocks = ceil(m / 2048).
extern "C" int egs_multi_cumsum_i32(const int32_t* x, int32_t* y, int32_t* sums,
                                    int rows, long long m, int n_blocks,
                                    void* stream) {
  return multi_cumsum<int32_t>(x, y, sums, rows, m, n_blocks, stream);
}

extern "C" int egs_multi_cumsum_f32(const float* x, float* y, float* sums,
                                    int rows, long long m, int n_blocks,
                                    void* stream) {
  return multi_cumsum<float>(x, y, sums, rows, m, n_blocks, stream);
}
