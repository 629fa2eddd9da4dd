// K8: stable LSD radix sort of int32 keys in [0, key_bound), carrying 32-bit
// payload columns, in one sweep per digit with decoupled look-back.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/radix.py
// `_concat_kernel` (reached through `counting_sort` and
// `counting_sort_by_tile`, per pass `_bucket_pass`), whose passes are a
// chunk-local bitonic sort, run tables, and a concatenation of the
// (bucket, chunk) runs by DMA on the TPU's sequential grid. None of that is
// carried over: blocks run in no order on an H100. Plain version:
// ops/kernels/radix.py::counting_sort_plain (a stable torch.sort and a
// gather); the kernel equals it bit for bit.
//
// What bounds it on an H100: bytes (each key read once a pass, each key and
// its 32-bit source index written once a pass; the payload columns move once,
// at the end, by that index: columns.cuh). A pass made of histogram, scan
// and scatter kernels pays three launches, and its scan of the per-block
// counts is work for one block while the other SMs idle. This design runs
// passes + 2 launches:
//   (1) radix_upfront: reads the keys once and counts the digits of every
//       pass (DIGIT_BITS = 8, from the least significant; the last pass takes
//       the remaining bits, clamped into its buckets, so a key outside
//       [0, key_bound) breaks the order, never memory: 2 passes for
//       binning's 2,171 tile ids, 3 for the reduce's 65,537 gaussian ids, 4
//       at 2^31 - 1). Each block (at most 64, launched cooperatively so
//       that all are resident) writes its counts to its own slot, so nothing
//       needs zeroing before it; after a grid barrier, one block per pass
//       sums the slots and scans them into the pass's digit offsets. It
//       also zeroes the tile counters and look-back words of every pass for
//       the launches after it.
//   (2) radix_scatter, one launch per pass, a tile of TILE = 4,096 keys per
//       CTA (256 threads x 16 keys). A CTA takes its tile index from the
//       pass's atomic counter, so every tile it waits on is held by a CTA
//       already running (no deadlock, whatever order the CTAs start in). It
//       ranks its keys stably by digit: each warp owns 512 consecutive keys
//       and ranks them in input order with __match_any_sync, the per-warp
//       counts are scanned across warps and across digits. It publishes its
//       256 digit counts as flagged words (2 flag bits, 30 bits of count:
//       m < 2^30) with release stores, tile 0 as inclusive prefixes, the
//       others as aggregates, and looks back over earlier tiles, 32 at a
//       time, until an inclusive prefix: the digit's offset plus that sum is
//       where the tile's run of the digit goes. The keys are reordered in
//       shared memory and each digit's run is written contiguously.
//   (3) one gather of the payload columns by the final source index.
// Keys ping-pong between two buffers; the source index rides along.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "columns.cuh"
#include "memory_order.cuh"

namespace {

constexpr int DIGIT_BITS = 8;
constexpr int RADIX = 1 << DIGIT_BITS;
constexpr int MAX_PASSES = 4;  // 31 bits
constexpr int THREADS = 256;   // one thread per digit in the scans
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // keys per scatter CTA
constexpr int WARP_KEYS = 32 * ITEMS;
constexpr int HIST_THREADS = 1024;
constexpr int HIST_ITEMS = 8;  // keys a thread loads before counting them
constexpr int MAX_HIST_BLOCKS = 64;
constexpr int PARTS = HIST_THREADS / RADIX;  // threads summing one digit's block counts
constexpr int LOOKBACK = 32;  // earlier tiles a look-back step reads at once
constexpr unsigned FLAG_AGGREGATE = 1u << 30;
constexpr unsigned FLAG_INCLUSIVE = 2u << 30;
constexpr unsigned COUNT_MASK = FLAG_AGGREGATE - 1;
static_assert(THREADS == RADIX, "the scans give each thread one digit");

struct Plan {
  int n_pass;
  int shift[MAX_PASSES];
  int buckets[MAX_PASSES];  // of the last pass; RADIX before it
  long long n_tiles;
  int hist_blocks;
};

// Passes of DIGIT_BITS from the least significant bit; the last one takes
// what is left of the bits of key_bound - 1 (at least one pass).
Plan make_plan(long long m, int key_bound) {
  Plan p{};
  int bits = 0;
  while (bits < 31 && ((long long)(key_bound - 1) >> bits) > 0) ++bits;
  p.n_pass = bits <= DIGIT_BITS ? 1 : (bits + DIGIT_BITS - 1) / DIGIT_BITS;
  for (int i = 0; i < p.n_pass; ++i) {
    p.shift[i] = i * DIGIT_BITS;
    p.buckets[i] = i + 1 < p.n_pass ? RADIX : ((key_bound - 1) >> p.shift[i]) + 1;
  }
  p.n_tiles = (m + TILE - 1) / TILE;
  p.hist_blocks = (int)(p.n_tiles < MAX_HIST_BLOCKS ? p.n_tiles : MAX_HIST_BLOCKS);
  return p;
}

// Scratch words: kbuf, ibuf0, ibuf1 [m], the upfront counts [hist_blocks x
// n_pass x RADIX], the digit offsets [n_pass x RADIX], the tile counters
// [MAX_PASSES], the look-back words [n_pass x n_tiles x RADIX].
long long scratch_words(long long m, const Plan& p) {
  return 3 * m + (long long)(p.hist_blocks + 1) * p.n_pass * RADIX + MAX_PASSES +
         (long long)p.n_pass * p.n_tiles * RADIX;
}

__device__ __forceinline__ int digit_of(int key, int shift, int last, int n_buckets) {
  const int d = key >> shift;
  if (!last) return d & (RADIX - 1);
  return min(max(d, 0), n_buckets - 1);
}

// Exclusive scan of x across the THREADS threads of the block (every thread
// calls it).
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) s_warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp_sums[w];
  __syncthreads();  // the sums may be overwritten by the next call
  return before + inc - x;
}

// (1) Digit counts of every pass, each block into its own
// counts[block][pass][RADIX]; then, after a grid barrier (a cooperative
// launch: every block is resident), each pass's digit offsets, the
// exclusive scan over digits of its counts summed over the blocks. Also
// zeroes the tile counters and the look-back words.
__global__ void __launch_bounds__(HIST_THREADS)
radix_upfront(const int* __restrict__ keys, long long m, Plan plan, int* __restrict__ counts,
              int* __restrict__ offsets, int* __restrict__ tile_counters,
              unsigned* __restrict__ lookback, long long lookback_words) {
  __shared__ int h[MAX_PASSES][RADIX];
  __shared__ int s_sums[WARPS];
  for (int i = threadIdx.x; i < MAX_PASSES * RADIX; i += HIST_THREADS) h[i / RADIX][i % RADIX] = 0;
  const long long stride = (long long)gridDim.x * HIST_THREADS;
  const long long gid = (long long)blockIdx.x * HIST_THREADS + threadIdx.x;
  for (long long i = gid; i < lookback_words; i += stride) lookback[i] = 0;
  if (gid < MAX_PASSES) tile_counters[gid] = 0;
  __syncthreads();
  for (long long base = (long long)blockIdx.x * HIST_THREADS * HIST_ITEMS; base < m;
       base += stride * HIST_ITEMS) {
    int key[HIST_ITEMS];
#pragma unroll
    for (int u = 0; u < HIST_ITEMS; ++u) {
      const long long g = base + u * HIST_THREADS + threadIdx.x;
      key[u] = g < m ? keys[g] : 0;
    }
#pragma unroll
    for (int u = 0; u < HIST_ITEMS; ++u) {
      if (base + u * HIST_THREADS + threadIdx.x < m) {
#pragma unroll
        for (int p = 0; p < MAX_PASSES; ++p)
          if (p < plan.n_pass)
            atomicAdd(&h[p][digit_of(key[u], plan.shift[p], p + 1 == plan.n_pass,
                                     plan.buckets[p])], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plan.n_pass * RADIX; i += HIST_THREADS)
    counts[(long long)blockIdx.x * plan.n_pass * RADIX + i] = h[i / RADIX][i % RADIX];

  cooperative_groups::this_grid().sync();

  // pass p's offsets: thread (part, d) sums digit d over every PARTS-th block
  const int d = threadIdx.x % RADIX, part = threadIdx.x / RADIX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = blockIdx.x; p < plan.n_pass; p += gridDim.x) {
    int sum = 0;
    for (int b = part; b < plan.hist_blocks; b += PARTS)
      sum += counts[((long long)b * plan.n_pass + p) * RADIX + d];
    h[part][d] = sum;
    __syncthreads();
    int total = 0, inc = 0;
    if (part == 0) {  // warps 0..WARPS-1: an exclusive scan over the digits
#pragma unroll
      for (int q = 0; q < PARTS; ++q) total += h[q][d];
      inc = total;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += y;
      }
      if (lane == 31) s_sums[warp] = inc;
    }
    __syncthreads();
    if (part == 0) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += s_sums[w];
      offsets[p * RADIX + d] = before + inc - total;
    }
    __syncthreads();
  }
}

// (2) One pass: stable scatter of keys and source indices (idx_in null: the
// source index is the position, on the first pass).
__global__ void __launch_bounds__(THREADS)
radix_scatter(const int* __restrict__ keys_in, const int* __restrict__ idx_in,
              int* __restrict__ keys_out, int* __restrict__ idx_out, long long m, Plan plan,
              int pass, int shift, int nb, const int* __restrict__ offsets,
              int* __restrict__ tile_counter, unsigned* __restrict__ lookback) {
  __shared__ int s_keys[TILE];
  __shared__ int s_idx[TILE];
  __shared__ int s_warp[WARPS][RADIX];  // per-warp digit counts, then their offsets
  __shared__ int s_start[RADIX];        // first local position of each digit
  __shared__ int s_base[RADIX];         // global position minus local position
  __shared__ int s_sums[WARPS];
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int last = pass + 1 == plan.n_pass;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int i = threadIdx.x; i < WARPS * RADIX; i += THREADS) s_warp[i / RADIX][i % RADIX] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const int n = (int)min((long long)TILE, m - base);

  // each warp owns keys [warp * WARP_KEYS, (warp + 1) * WARP_KEYS) of the
  // tile; its item j of lane l is key warp * WARP_KEYS + j * 32 + l
  int key[ITEMS], src[ITEMS], rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int pos = warp * WARP_KEYS + j * 32 + lane;
    key[j] = pos < n ? keys_in[base + pos] : 0;
    src[j] = pos < n ? (idx_in ? idx_in[base + pos] : (int)(base + pos)) : 0;
  }
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool valid = warp * WARP_KEYS + j * 32 + lane < n;
    const int d = valid ? digit_of(key[j], shift, last, nb) : RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid) rank[j] = s_warp[warp][d] + __popc(peers & lanes_below);
    __syncwarp();
    if (valid && (peers & lanes_below) == 0) s_warp[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // thread d: digit d's offsets across warps, its count, its local start
  const int d = threadIdx.x;
  int count = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_warp[w][d];
    s_warp[w][d] = count;
    count += c;
  }
  s_start[d] = block_exclusive_scan(count, s_sums);
  unsigned* word = lookback + ((long long)pass * plan.n_tiles + tile) * RADIX + d;
  store_release(word, (tile == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE) | (unsigned)count);
  const int offsets_d = offsets[pass * RADIX + d];  // where the pass puts digit d's first key
  int excl = offsets_d;
  __syncthreads();

  // reorder the tile by digit in shared memory (stable: ranks follow input order)
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (warp * WARP_KEYS + j * 32 + lane < n) {
      const int dj = digit_of(key[j], shift, last, nb);
      const int at = s_start[dj] + s_warp[warp][dj] + rank[j];
      s_keys[at] = key[j];
      s_idx[at] = src[j];
    }
  }

  // decoupled look-back: add earlier tiles' counts of digit d, LOOKBACK
  // tiles a step, up to the nearest that has published its inclusive
  // prefix (tile 0 does so at once); a step that meets a tile not yet
  // published resumes there. The loads are relaxed, so that a step's
  // loads are all in flight at once; the fence after the look-back gives
  // them acquire order
  if (tile > 0) {
    const unsigned* words = lookback + (long long)pass * plan.n_tiles * RADIX + d;
    for (long long k = tile - 1;;) {
      unsigned v[LOOKBACK];
#pragma unroll
      for (int w = 0; w < LOOKBACK; ++w)
        v[w] = k - w >= 0 ? load_relaxed(words + (k - w) * RADIX) : FLAG_INCLUSIVE;
      int used = 0;
      bool stop = false, done = false;
#pragma unroll
      for (int w = 0; w < LOOKBACK; ++w) {
        if (!stop) {
          if ((v[w] & ~COUNT_MASK) == 0) {
            stop = true;
          } else {
            excl += (int)(v[w] & COUNT_MASK);
            ++used;
            if (v[w] & FLAG_INCLUSIVE) stop = done = true;
          }
        }
      }
      if (done) break;
      k -= used;
    }
    __threadfence();
    store_release(word, FLAG_INCLUSIVE | (unsigned)(excl - offsets_d + count));
  }
  s_base[d] = excl - s_start[d];
  __syncthreads();

  // each digit's run lands contiguously
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int k = s_keys[i];
    const int dst = s_base[digit_of(k, shift, last, nb)] + i;
    keys_out[dst] = k;
    idx_out[dst] = s_idx[i];
  }
}

}  // namespace

// Stable sort of key_in [m] (values in [0, key_bound)) into key_out [m];
// vals_in / vals_out: host arrays of n_vals device pointers to [m] 32-bit
// payload columns. scratch: int32 words of device memory, as many as
// egs_counting_sort_plan gives (checked here); nothing in it needs
// initialising. m < 2^30 (the look-back words hold 30-bit counts).
extern "C" int egs_counting_sort(const int* key_in, int* key_out, const void* const* vals_in,
                                 void* const* vals_out, int n_vals, int* scratch,
                                 long long n_scratch, long long m, int key_bound, void* stream) {
  if (m <= 0) return 0;
  if (key_bound < 1 || n_vals < 0 || n_vals > MAX_COLUMNS || m >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(m, key_bound);
  if (n_scratch < scratch_words(m, plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* kbuf = scratch;
  int* ibuf[2] = {scratch + m, scratch + 2 * m};
  int* counts = scratch + 3 * m;
  int* offsets = counts + (long long)plan.hist_blocks * plan.n_pass * RADIX;
  int* tile_counters = offsets + plan.n_pass * RADIX;
  unsigned* lookback = reinterpret_cast<unsigned*>(tile_counters + MAX_PASSES);
  const long long lookback_words = (long long)plan.n_pass * plan.n_tiles * RADIX;
  void* args[] = {(void*)&key_in, (void*)&m,        (void*)&plan,     (void*)&counts,
                  (void*)&offsets, (void*)&tile_counters, (void*)&lookback,
                  (void*)&lookback_words};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)radix_upfront, dim3(plan.hist_blocks),
                                              dim3(HIST_THREADS), args, 0, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int* ksrc = key_in;
  const int* isrc = nullptr;
  for (int p = 0; p < plan.n_pass; ++p) {
    int* kdst = (plan.n_pass - 1 - p) % 2 == 0 ? key_out : kbuf;  // the last pass lands in key_out
    int* idst = ibuf[p % 2];
    radix_scatter<<<(unsigned)plan.n_tiles, THREADS, 0, s>>>(
        ksrc, isrc, kdst, idst, m, plan, p, plan.shift[p], plan.buckets[p], offsets,
        tile_counters + p, lookback);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ksrc = kdst;
    isrc = idst;
  }
  if (n_vals > 0)
    gather_columns<<<gather_blocks(m), GATHER_THREADS, 0, s>>>(
        isrc, make_columns(vals_in, vals_out, n_vals), n_vals, m);
  return (int)cudaGetLastError();
}

// The plan of a call of egs_counting_sort (the same m and key_bound): its
// passes, so 1 + passes launches before the payload gather, and the int32
// words of scratch it needs. The wrapper sizes its scratch by it; nothing
// else holds a copy.
extern "C" int egs_counting_sort_plan(long long m, int key_bound, long long* passes,
                                      long long* n_scratch) {
  if (m < 0 || key_bound < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(m, key_bound);
  *passes = plan.n_pass;
  *n_scratch = scratch_words(m, plan);
  return 0;
}
