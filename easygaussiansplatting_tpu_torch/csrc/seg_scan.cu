// K6: multi-row inclusive segmented sum (float32), restarting at flagged
// segment starts shared by all rows.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/scan.py
// `_seg_scan_kernel` (reached through `segmented_cumsum` from the gradient
// reduce `_sort_reduce_grads`), which walks lane blocks in order on the TPU's
// one core and carries the open segment's running sum in VMEM scratch.
// Plain version: ops/kernels/scan.py::segmented_cumsum_plain (a float64
// cumsum minus the running total at each segment start).
//
// What bounds it on an H100: bytes — each element is read and written once
// (9 gradient rows plus one shared flag word: 76 B per position, ~42 MB at
// 557,056 positions), against one add. Blocks run in no order on 132 SMs, so
// the carry becomes K3's reduce-then-scan over the segmented-sum monoid on
// (value, has-start) pairs, combine(a, b) = (b.f ? b.v : a.v + b.v, a.f | b.f):
//   (1) every block of TILE positions writes its aggregate: the sum after its
//       last start (all of it if none) and whether it holds a start;
//   (2) one block per row turns the aggregates into each block's carry-in;
//   (3) every block scans its positions again; the carry reaches exactly the
//       positions before the block's first start (the TPU kernel's round-3
//       carry bug sat at this boundary).
// Element 0 always starts a segment. Sums run in a fixed order, so the result
// is the same on every run; no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // positions per block
constexpr int WARPS = THREADS / 32;

// (v, f) <- combine(prefix (pv, pf), (v, f))
__device__ __forceinline__ void combine(float pv, int pf, float& v, int& f) {
  if (!f) v = pv + v;
  f |= pf;
}

// Inclusive segmented scan of one (v, f) pair per thread across the block.
// Returns the thread's EXCLUSIVE prefix in (*ev, *ef) and the block's
// aggregate in (*tv, *tf).
__device__ __forceinline__ void block_seg_scan(float v, int f, float* ev, int* ef,
                                               float* tv, int* tf) {
  __shared__ float s_v[THREADS];
  __shared__ int s_f[THREADS];
  __shared__ float w_v[WARPS];
  __shared__ int w_f[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float pv = __shfl_up_sync(0xffffffffu, v, off);
    const int pf = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off) combine(pv, pf, v, f);
  }
  if (lane == 31) {
    w_v[warp] = v;
    w_f[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    float wv = lane < WARPS ? w_v[lane] : 0.0f;
    int wf = lane < WARPS ? w_f[lane] : 0;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const float pv = __shfl_up_sync(0xffffffffu, wv, off);
      const int pf = __shfl_up_sync(0xffffffffu, wf, off);
      if (lane >= off) combine(pv, pf, wv, wf);
    }
    if (lane < WARPS) {
      w_v[lane] = wv;
      w_f[lane] = wf;
    }
  }
  __syncthreads();
  if (warp > 0) combine(w_v[warp - 1], w_f[warp - 1], v, f);
  s_v[threadIdx.x] = v;
  s_f[threadIdx.x] = f;
  __syncthreads();
  *ev = threadIdx.x > 0 ? s_v[threadIdx.x - 1] : 0.0f;
  *ef = threadIdx.x > 0 ? s_f[threadIdx.x - 1] : 0;
  *tv = s_v[THREADS - 1];
  *tf = s_f[THREADS - 1];
  __syncthreads();  // the shared arrays are reused by the next call
}

// The (v, f) aggregate of the ITEMS positions thread t owns,
// base + t*ITEMS .. +ITEMS-1.
__device__ __forceinline__ void thread_aggregate(const float* xr, const int* flags,
                                                 long long first, long long m,
                                                 float* v, int* f) {
  float run = 0.0f;
  int any = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long idx = first + i;
    if (idx < m) {
      if (idx == 0 || flags[idx] != 0) {
        run = 0.0f;
        any = 1;
      }
      run += xr[idx];
    }
  }
  *v = run;
  *f = any;
}

// (1) block aggregates: grid (n_blocks, rows)
__global__ void __launch_bounds__(THREADS)
seg_block_sums(const float* __restrict__ x, const int* __restrict__ flags,
               float* __restrict__ sums, int* __restrict__ bflags, long long m,
               int n_blocks) {
  const int row = blockIdx.y;
  const long long first = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  float v, ev, tv;
  int f, ef, tf;
  thread_aggregate(x + (long long)row * m, flags, first, m, &v, &f);
  block_seg_scan(v, f, &ev, &ef, &tv, &tf);
  if (threadIdx.x == 0) {
    sums[(long long)row * n_blocks + blockIdx.x] = tv;
    if (row == 0) bflags[blockIdx.x] = tf;
  }
}

// (2) each block's carry-in (the value of the exclusive segmented scan of
// the aggregates), written over the aggregates: grid (rows)
__global__ void __launch_bounds__(THREADS)
seg_block_carries(float* __restrict__ sums, const int* __restrict__ bflags,
                  int n_blocks) {
  float* s = sums + (long long)blockIdx.x * n_blocks;
  float run_v = 0.0f;
  int run_f = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += THREADS) {
    const int b = b0 + threadIdx.x;
    const float v = b < n_blocks ? s[b] : 0.0f;
    const int f = b < n_blocks ? bflags[b] : 0;
    float ev, tv;
    int ef, tf;
    block_seg_scan(v, f, &ev, &ef, &tv, &tf);
    combine(run_v, run_f, ev, ef);
    if (b < n_blocks) s[b] = ev;
    combine(run_v, run_f, tv, tf);
    run_v = tv;
    run_f = tf;
  }
}

// (3) scan each block with its carry-in: grid (n_blocks, rows)
__global__ void __launch_bounds__(THREADS)
seg_scan_apply(const float* __restrict__ x, const int* __restrict__ flags,
               float* __restrict__ y, const float* __restrict__ carries,
               long long m, int n_blocks) {
  const int row = blockIdx.y;
  const long long first = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  const float* xr = x + (long long)row * m;
  float* yr = y + (long long)row * m;
  float v, ev, tv;
  int f, ef, tf;
  thread_aggregate(xr, flags, first, m, &v, &f);
  block_seg_scan(v, f, &ev, &ef, &tv, &tf);
  // the block's carry-in reaches the positions before its first start
  combine(carries[(long long)row * n_blocks + blockIdx.x], 0, ev, ef);
  float run = ev;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long idx = first + i;
    if (idx < m) {
      if (idx == 0 || flags[idx] != 0) run = 0.0f;
      run += xr[idx];
      yr[idx] = run;
    }
  }
}

}  // namespace

// x, y: [rows, m] float32 contiguous device arrays; flags [m] int32 (nonzero
// starts a segment); sums [rows, n_blocks] float32 and bflags [n_blocks] int32
// device scratch with n_blocks = ceil(m / 2048).
extern "C" int egs_segmented_cumsum_f32(const float* x, const int* flags, float* y,
                                        float* sums, int* bflags, int rows,
                                        long long m, int n_blocks, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  if (n_blocks != (int)((m + TILE - 1) / TILE)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_blocks, rows);
  seg_block_sums<<<grid, THREADS, 0, s>>>(x, flags, sums, bflags, m, n_blocks);
  seg_block_carries<<<rows, THREADS, 0, s>>>(sums, bflags, n_blocks);
  seg_scan_apply<<<grid, THREADS, 0, s>>>(x, flags, y, sums, m, n_blocks);
  return (int)cudaGetLastError();
}
