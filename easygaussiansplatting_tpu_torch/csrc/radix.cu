// K8: stable LSD counting sort of int32 keys in [0, key_bound), carrying
// 32-bit payload columns.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/radix.py
// `_concat_kernel` (reached through `counting_sort` and
// `counting_sort_by_tile`, per pass `_bucket_pass`), whose passes are a
// chunk-local bitonic sort, run tables, and a concatenation of the
// (bucket, chunk) runs by DMA on the TPU's sequential grid. None of that is
// carried over: blocks run in no order on an H100, so each pass here is the
// GPU's histogram, prefix and stable scatter. Plain version:
// ops/kernels/radix.py::counting_sort_plain (a stable torch.sort and a
// gather); the kernel equals it bit for bit.
//
// What bounds it on an H100: bytes. A pass reads the keys twice (histogram,
// scatter) and writes each key and its 32-bit source index once; the
// payload columns move once, by that index, at the end (columns.cuh).
// Per pass (6-bit digits from the least significant; the last pass takes the
// remaining bits exactly, as the JAX passes do: 2 passes for binning's 2,171
// tile ids, 3 for the reduce's 65,537 gaussian ids):
//   (1) every block of TILE keys counts its digits in shared memory and
//       writes them into a [digits x blocks] table, digit-major;
//   (2) one block turns the table into its exclusive scan: entry (d, b) is
//       then where block b's first key with digit d goes;
//   (3) every block walks its keys in input order, ITEMS rounds of THREADS
//       keys: within a warp a key's rank among earlier lanes with its digit
//       is __popc(__match_any_sync(digit) & lanes below), across warps the
//       per-warp digit counts are prefix-summed in warp order, and each
//       digit's running position carries from round to round. So keys with
//       one digit keep their input order: the sort is stable.
// Keys ping-pong between two buffers; the source index rides along.

#include <cuda_runtime.h>

#include "columns.cuh"

namespace {

constexpr int DIGIT_BITS = 6;
constexpr int RADIX = 1 << DIGIT_BITS;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // keys per block
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;

// A key's digit in a pass: 6 bits at `shift`, or in the last pass all bits
// from `shift` up, clamped into the pass's buckets (a key outside
// [0, key_bound) breaks the order, never memory).
__device__ __forceinline__ int digit_of(int key, int shift, int last, int n_buckets) {
  const int d = key >> shift;
  if (!last) return d & (RADIX - 1);
  return min(max(d, 0), n_buckets - 1);
}

// (1) per-block digit counts into counts[d * n_blocks + b]
__global__ void __launch_bounds__(THREADS)
radix_histogram(const int* __restrict__ keys, long long m, int shift, int last,
                int n_buckets, int* __restrict__ counts, int n_blocks) {
  __shared__ int h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += THREADS) h[d] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long g = base + (long long)r * THREADS + threadIdx.x;
    if (g < m) atomicAdd(&h[digit_of(keys[g], shift, last, n_buckets)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_buckets; d += THREADS)
    counts[(long long)d * n_blocks + blockIdx.x] = h[d];
}

// (2) exclusive scan of counts[0:n] in place, one block: each thread owns a
// contiguous run; the run totals are scanned across the block.
__global__ void __launch_bounds__(SCAN_THREADS)
radix_scan(int* __restrict__ counts, long long n) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < n ? lo + per : n;
  int sum = 0;
  for (long long i = lo; i < hi; ++i) sum += counts[i];
  int x = sum;  // inclusive scan of the run totals across the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (long long i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
}

// (3) stable scatter of keys and source indices (idx_in null: the source
// index is the position, on the first pass)
__global__ void __launch_bounds__(THREADS)
radix_scatter(const int* __restrict__ keys_in, const int* __restrict__ idx_in,
              int* __restrict__ keys_out, int* __restrict__ idx_out,
              const int* __restrict__ offsets, long long m, int shift, int last,
              int n_buckets, int n_blocks) {
  __shared__ int s_next[RADIX];          // next output position of each digit
  __shared__ int s_warp[WARPS][RADIX];   // a round's per-warp counts, then offsets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < RADIX; d += THREADS)
    s_next[d] = d < n_buckets ? offsets[(long long)d * n_blocks + blockIdx.x] : 0;
  for (int t = threadIdx.x; t < WARPS * RADIX; t += THREADS) s_warp[t / RADIX][t % RADIX] = 0;
  __syncthreads();
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  for (int r = 0; r < ITEMS; ++r) {
    const long long g = base + (long long)r * THREADS + threadIdx.x;
    const bool valid = g < m;
    int key = 0, src = 0, d = RADIX;  // lanes past m share the digit RADIX and write nothing
    if (valid) {
      key = keys_in[g];
      src = idx_in ? idx_in[g] : (int)g;
      d = digit_of(key, shift, last, n_buckets);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lanes_below);
    if (valid && rank == 0) s_warp[warp][d] = __popc(peers);
    __syncthreads();
    for (int dd = threadIdx.x; dd < RADIX; dd += THREADS) {
      int run = s_next[dd];
      for (int w = 0; w < WARPS; ++w) {
        const int c = s_warp[w][dd];
        s_warp[w][dd] = run;
        run += c;
      }
      s_next[dd] = run;
    }
    __syncthreads();
    if (valid) {
      const int dst = s_warp[warp][d] + rank;
      keys_out[dst] = key;
      idx_out[dst] = src;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < WARPS * RADIX; t += THREADS) s_warp[t / RADIX][t % RADIX] = 0;
    __syncthreads();
  }
}

}  // namespace

// Stable sort of key_in [m] (values in [0, key_bound)) into key_out [m];
// vals_in / vals_out: host arrays of n_vals device pointers to [m] 32-bit
// payload columns. Device scratch: kbuf, ibuf0, ibuf1 [m] int32 and counts
// [64 * n_blocks] int32, with n_blocks = ceil(m / 2048).
extern "C" int egs_counting_sort(const int* key_in, int* key_out, const void* const* vals_in,
                                 void* const* vals_out, int n_vals, int* kbuf, int* ibuf0,
                                 int* ibuf1, int* counts, long long m, int key_bound,
                                 int n_blocks, void* stream) {
  if (m <= 0) return 0;
  if (key_bound < 1 || n_vals < 0 || n_vals > MAX_COLUMNS ||
      n_blocks != (int)((m + TILE - 1) / TILE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int shifts[8], n_pass = 0;
  for (int shift = 0;; shift += DIGIT_BITS) {
    shifts[n_pass++] = shift;
    if (((key_bound - 1) >> shift) < RADIX) break;
  }
  const int* ksrc = key_in;
  const int* isrc = nullptr;
  for (int p = 0; p < n_pass; ++p) {
    const int last = p == n_pass - 1;
    const int nb = last ? ((key_bound - 1) >> shifts[p]) + 1 : RADIX;
    int* kdst = (n_pass - 1 - p) % 2 == 0 ? key_out : kbuf;  // the last pass lands in key_out
    int* idst = p % 2 == 0 ? ibuf0 : ibuf1;
    radix_histogram<<<n_blocks, THREADS, 0, s>>>(ksrc, m, shifts[p], last, nb, counts, n_blocks);
    radix_scan<<<1, SCAN_THREADS, 0, s>>>(counts, (long long)nb * n_blocks);
    radix_scatter<<<n_blocks, THREADS, 0, s>>>(ksrc, isrc, kdst, idst, counts, m, shifts[p],
                                               last, nb, n_blocks);
    ksrc = kdst;
    isrc = idst;
  }
  if (n_vals > 0)
    gather_columns<<<gather_blocks(m), GATHER_THREADS, 0, s>>>(
        isrc, make_columns(vals_in, vals_out, n_vals), n_vals, m);
  return (int)cudaGetLastError();
}
