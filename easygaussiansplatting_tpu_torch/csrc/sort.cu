// K7: stable merge sort of int32 keys (one word, or two compared
// lexicographically) carrying 32-bit payload columns.
//
// Replaces the Pallas kernels easygaussiansplatting_tpu/ops/pallas/sort.py
// `_local_kernel` (every bitonic stage with a distance below the block, in
// VMEM) and `_cross_kernel` (one stage between two blocks), reached through
// `sort_pairs` and `sort_blocks`. Plain version:
// ops/kernels/sort.py::sort_pairs_plain / sort_blocks_plain (a stable
// torch.sort and a gather).
//
// What bounds it on an H100: bytes at best (each key word and payload read
// once and written once). A comparison sort cannot reach that: it moves the
// key words and a source index once per merge level, and at the routes'
// sizes (65,536 to 2^21 entries, one wave of CTAs) each level is bound by
// its latency more than by its bytes. A bitonic network, the TPU kernel's
// design, pads m to a power of two (the gradient reduce's 557,056 keys
// become 2^20) and runs log2(m)^2 / 2 stages, on a GPU one launch per
// global stage (about 55 launches at 2^20). This design runs
// ceil(log2(m / TILE)) + 2 launches on exactly m entries:
//   (1) cta_sort: each CTA sorts one tile of TILE = 4,096 entries (or each
//       `block` of them, for sort_blocks with block < TILE): THREADS = 512
//       threads hold ITEMS = 8 consecutive entries each in registers, sort
//       them with a stable odd-even transposition network, then merge runs
//       of 8, 16, ... in shared memory (a merge-path split by binary search
//       and a serial merge of 8 outputs per thread, per round). Entries past
//       m in the last tile are pads (INT32_MAX key words) behind every real
//       entry, never stored. The shared arrays carry a padding word every 32
//       entries, so a warp's loads and stores of its threads' 8 consecutive
//       entries do not conflict on banks.
//   (2) merge_pass, once per doubling of the run width w from TILE: each CTA
//       makes TILE outputs of one merged pair of runs. The block finds where
//       its two diagonals cross the merge path by a cooperative search
//       (each of 512 threads tests one point of each per round, all loads in
//       flight together; __syncthreads_count narrows the ranges: two rounds
//       up to 2^18 in place of ~20 dependent loads), loads the two input
//       slices coalesced into shared memory, merges 8 outputs per thread,
//       and stores them coalesced. The last run may be short or empty; the
//       buffers ping-pong at length m.
//   (3) one gather (columns.cuh) moves every payload column by the final
//       source index, so ten payload columns cost one pass, not one per level.
// Every merge takes from the left run on equal keys, and the left run holds
// the earlier source positions, so the result is the stable sort: equal to
// the plain version exactly. sort_blocks stops the merges at `block`.

#include <cuda_runtime.h>

#include "columns.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // entries per CTA in both kernels
constexpr int PAD = 0x7fffffff;

// a < b on the key words (NK of them), lexicographic on signed int32
template <int NK>
__device__ __forceinline__ bool less(int a0, int a1, int b0, int b1) {
  if (a0 != b0) return a0 < b0;
  return NK == 2 && a1 < b1;
}

// The entries of a tile in shared memory: key words and source index, one
// array each, with a padding word after every 32 entries. Without it a
// thread's 8 consecutive entries (8t + k) fall into 4 banks across a warp,
// an 8-way conflict on every load and store of a thread's items.
constexpr int SLOTS = TILE + TILE / 32;

__device__ __forceinline__ int slot(int p) { return p + (p >> 5); }

template <int NK>
struct Smem {
  int* k0;
  int* k1;
  int* ix;
  __device__ explicit Smem(int* base)
      : k0(base), k1(NK == 2 ? base + SLOTS : nullptr), ix(base + NK * SLOTS) {}
  __device__ int key0(int p) const { return k0[slot(p)]; }
  __device__ int key1(int p) const { return NK == 2 ? k1[slot(p)] : 0; }
  __device__ int index(int p) const { return ix[slot(p)]; }
  __device__ void put(int p, int w0, int w1, int i) const {
    k0[slot(p)] = w0;
    if (NK == 2) k1[slot(p)] = w1;
    ix[slot(p)] = i;
  }
  __device__ bool lt(int p, int q) const {  // entry p < entry q by key
    return less<NK>(key0(p), key1(p), key0(q), key1(q));
  }
};

inline size_t smem_bytes(int nk) { return (size_t)(nk + 1) * SLOTS * sizeof(int); }

// Merge of the sorted runs [a, a + na) and [b, b + nb) in shared memory:
// the `cnt` (<= ITEMS) outputs from position `diag` of the stable merge
// into registers. The split is a binary search on the diagonal.
template <int NK>
__device__ __forceinline__ void merge_items(const Smem<NK>& s, int a, int na, int b, int nb,
                                            int diag, int cnt, int (&r0)[ITEMS],
                                            int (&r1)[ITEMS], int (&ri)[ITEMS]) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s.lt(b + diag - 1 - mid, a + mid))
      hi = mid;
    else
      lo = mid + 1;
  }
  int i = a + lo, j = b + diag - lo;
  const int ie = a + na, je = b + nb;
  // the two runs' heads stay in registers: a step compares registers and
  // loads only the next head of the run it took from (selects, not
  // branches: the threads of a warp take from different runs)
  int a0 = i < ie ? s.key0(i) : 0, a1 = i < ie ? s.key1(i) : 0;
  int b0 = j < je ? s.key0(j) : 0, b1 = j < je ? s.key1(j) : 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (k < cnt) {
      const bool take_a = j >= je || (i < ie && !less<NK>(b0, b1, a0, a1));
      r0[k] = take_a ? a0 : b0;
      r1[k] = take_a ? a1 : b1;
      const int p = take_a ? i : j;
      ri[k] = s.index(p);
      const int next = p + 1;
      const bool more = next < (take_a ? ie : je);
      const int n0 = more ? s.key0(next) : 0, n1 = more ? s.key1(next) : 0;
      a0 = take_a ? n0 : a0;
      a1 = take_a ? n1 : a1;
      b0 = take_a ? b0 : n0;
      b1 = take_a ? b1 : n1;
      i = take_a ? next : i;
      j = take_a ? j : next;
    }
  }
}

template <int NK>
__device__ __forceinline__ void put_items(const Smem<NK>& s, int at, int cnt,
                                          const int (&r0)[ITEMS], const int (&r1)[ITEMS],
                                          const int (&ri)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (k < cnt) s.put(at + k, r0[k], r1[k], ri[k]);
  }
}

// (1) Sort each run of `run` entries (a power of two, 2 * ITEMS <= run <=
// TILE) of the tile at blockIdx.x * TILE, read from the inputs (source index
// = position), into the work arrays.
template <int NK>
__global__ void __launch_bounds__(THREADS, 2)
cta_sort(const int* __restrict__ in0, const int* __restrict__ in1, int* __restrict__ o0,
         int* __restrict__ o1, int* __restrict__ oi, long long m, int run) {
  extern __shared__ int smem[];
  const Smem<NK> s(smem);
  const long long base = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, m - base);
  {
    // every load of the tile in flight before the first store
    int w0[ITEMS], w1[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int t = threadIdx.x + k * THREADS;
      w0[k] = t < n ? in0[base + t] : PAD;
      w1[k] = NK == 2 && t < n ? in1[base + t] : PAD;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int t = threadIdx.x + k * THREADS;
      s.put(t, w0[k], w1[k], (int)(base + t));
    }
  }
  __syncthreads();
  int r0[ITEMS], r1[ITEMS], ri[ITEMS];
  const int own = threadIdx.x * ITEMS;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    r0[k] = s.key0(own + k);
    r1[k] = s.key1(own + k);
    ri[k] = s.index(own + k);
  }
  // odd-even transposition: swaps only entries strictly out of order, so
  // equal keys keep their positions (stable); ITEMS rounds sort ITEMS items
#pragma unroll
  for (int round = 0; round < ITEMS; ++round) {
#pragma unroll
    for (int k = round & 1; k + 1 < ITEMS; k += 2) {
      if (less<NK>(r0[k + 1], r1[k + 1], r0[k], r1[k])) {
        int t = r0[k]; r0[k] = r0[k + 1]; r0[k + 1] = t;
        t = r1[k]; r1[k] = r1[k + 1]; r1[k + 1] = t;
        t = ri[k]; ri[k] = ri[k + 1]; ri[k + 1] = t;
      }
    }
  }
  for (int w = ITEMS; w < run; w <<= 1) {
    __syncthreads();  // every thread has read the previous round
    put_items(s, own, ITEMS, r0, r1, ri);
    __syncthreads();
    const int start = own / (2 * w) * (2 * w);
    merge_items(s, start, w, start + w, w, own - start, ITEMS, r0, r1, ri);
  }
  __syncthreads();
  put_items(s, own, ITEMS, r0, r1, ri);
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += THREADS) {
    o0[base + t] = s.key0(t);
    if (NK == 2) o1[base + t] = s.key1(t);
    oi[base + t] = s.index(t);
  }
}

// Entries of run A among the first d outputs of the stable merge of the
// runs A = [a, a + na) and B = [b, b + nb) in device memory, for the two
// diagonals d0 <= d1 of a block at once: the first q with
// B[d - 1 - q] < A[q]. Each round tests up to THREADS evenly spaced points
// of each range (all loads of both in flight together) and keeps the gap
// between the last false and the first true: two rounds up to 2^18. Every
// thread of the block calls it and gets the same answers.
template <int NK>
__device__ void path_search(const int* __restrict__ k0, const int* __restrict__ k1, long long a,
                            int na, long long b, int nb, int d0, int d1, int& i0, int& i1) {
  const int d[2] = {d0, d1};
  int lo[2] = {max(0, d0 - nb), max(0, d1 - nb)}, hi[2] = {min(d0, na), min(d1, na)};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2], count[2], wa0[2], wa1[2], wb0[2], wb1[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = hi[r] - lo[r];
      step[r] = n > 0 ? (n + THREADS - 1) / THREADS : 1;
      count[r] = n > 0 ? (n + step[r] - 1) / step[r] : 0;  // samples, all below hi
      live[r] = (int)threadIdx.x < count[r];
      const int q = lo[r] + (int)threadIdx.x * step[r];
      const long long qa = a + q, qb = b + d[r] - 1 - q;
      wa0[r] = live[r] ? k0[qa] : 0;
      wa1[r] = NK == 2 && live[r] ? k1[qa] : 0;
      wb0[r] = live[r] ? k0[qb] : 0;
      wb1[r] = NK == 2 && live[r] ? k1[qb] : 0;
    }
    const int n_true0 =
        __syncthreads_count(live[0] && less<NK>(wb0[0], wb1[0], wa0[0], wa1[0]));
    const int n_true1 =
        __syncthreads_count(live[1] && less<NK>(wb0[1], wb1[1], wa0[1], wa1[1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (lo[r] < hi[r]) {
        const int first_true = count[r] - (r == 0 ? n_true0 : n_true1);
        const int new_hi = first_true < count[r] ? lo[r] + first_true * step[r] : hi[r];
        if (first_true > 0) lo[r] += (first_true - 1) * step[r] + 1;
        hi[r] = new_hi;
      }
    }
  }
  i0 = lo[0];
  i1 = lo[1];
}

// (2) One merge level: sorted runs of width w (the last one may be short)
// into runs of 2w. Block c makes outputs [c * TILE, (c + 1) * TILE).
template <int NK>
__global__ void __launch_bounds__(THREADS, 2)
merge_pass(const int* __restrict__ k0, const int* __restrict__ k1, const int* __restrict__ ix,
           int* __restrict__ o0, int* __restrict__ o1, int* __restrict__ oi, long long m,
           long long w) {
  extern __shared__ int smem[];
  const Smem<NK> s(smem);
  const long long out_lo = (long long)blockIdx.x * TILE;
  const long long start = out_lo / (2 * w) * (2 * w);
  const long long a = start, mid = min(start + w, m), end = min(start + 2 * w, m);
  const int na = (int)(mid - a), nb = (int)(end - mid);  // m < 2^30
  const int d0 = (int)(out_lo - start), d1 = min(d0 + TILE, na + nb);
  int i0, i1;
  path_search<NK>(k0, k1, a, na, mid, nb, d0, d1, i0, i1);
  const int la = i1 - i0, n = d1 - d0;
  const long long a_from = a + i0, b_from = mid + (d0 - i0) - la;
  {
    // every load of the two slices in flight before the first store
    int w0[ITEMS], w1[ITEMS], wi[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int t = threadIdx.x + k * THREADS;
      const long long g = t < la ? a_from + t : b_from + t;
      w0[k] = t < n ? k0[g] : 0;
      w1[k] = NK == 2 && t < n ? k1[g] : 0;
      wi[k] = t < n ? ix[g] : 0;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int t = threadIdx.x + k * THREADS;
      if (t < n) s.put(t, w0[k], w1[k], wi[k]);
    }
  }
  __syncthreads();
  int r0[ITEMS], r1[ITEMS], ri[ITEMS];
  const int own = threadIdx.x * ITEMS;
  const int cnt = max(0, min(ITEMS, n - own));
  merge_items(s, 0, la, la, n - la, min(own, n), cnt, r0, r1, ri);
  __syncthreads();
  put_items(s, own, cnt, r0, r1, ri);
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += THREADS) {
    o0[out_lo + t] = s.key0(t);
    if (NK == 2) o1[out_lo + t] = s.key1(t);
    oi[out_lo + t] = s.index(t);
  }
}

// Merge levels from TILE (or `block`, when smaller) up to `run`.
int merge_levels(long long m, long long run) {
  int n = 0;
  for (long long w = TILE; w < run && w < m; w <<= 1) ++n;
  return n;
}

// Scratch words: the sorted entries' source indices, then the ping-pong
// copies of the key words and indices, all [m].
long long scratch_words(long long m, int n_keys) { return (n_keys + 2) * m; }

template <int NK>
cudaError_t sort_words(const int* in0, const int* in1, int* out0, int* out1, int* out_ix,
                       int* tmp0, int* tmp1, int* tmp_ix, long long m, long long run,
                       cudaStream_t st) {
  const size_t bytes = smem_bytes(NK);
  cudaError_t e = cudaFuncSetAttribute(cta_sort<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(merge_pass<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e != cudaSuccess) return e;
  const int levels = merge_levels(m, run);
  const unsigned grid = (unsigned)((m + TILE - 1) / TILE);
  // the last level lands in the output arrays
  int *d0 = levels % 2 ? tmp0 : out0, *d1 = levels % 2 ? tmp1 : out1,
      *di = levels % 2 ? tmp_ix : out_ix;
  int *e0 = levels % 2 ? out0 : tmp0, *e1 = levels % 2 ? out1 : tmp1,
      *ei = levels % 2 ? out_ix : tmp_ix;
  cta_sort<NK><<<grid, THREADS, bytes, st>>>(in0, in1, d0, d1, di, m,
                                             (int)(run < TILE ? run : TILE));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  long long w = TILE;
  for (int l = 0; l < levels; ++l, w <<= 1) {
    merge_pass<NK><<<grid, THREADS, bytes, st>>>(d0, d1, di, e0, e1, ei, m, w);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    int* t = d0; d0 = e0; e0 = t;
    t = d1; d1 = e1; e1 = t;
    t = di; di = ei; ei = t;
  }
  return cudaSuccess;
}

}  // namespace

// Sorts m entries by (k0[, k1]) ascending, stably; with block > 0, each run
// of `block` entries on its own (block: a power of two >= 2 * ITEMS dividing
// m), else all m together.
//   k0_in, k1_in: [m] int32 key words (k1_in null when n_keys == 1);
//   vals_in, vals_out: host arrays of n_vals device pointers to [m] 32-bit
//     payload columns, in and out;
//   k0_out, k1_out: [m] int32, the sorted key words (k1_out null when
//     n_keys == 1);
//   scratch: int32 words of device memory, as many as egs_sort_plan gives;
//     nothing in it needs initialising;
//   n_scratch: its length, checked.
extern "C" int egs_sort(const int* k0_in, const int* k1_in, int n_keys,
                        const void* const* vals_in, void* const* vals_out, int n_vals,
                        int* k0_out, int* k1_out, int* scratch, long long n_scratch,
                        long long m, long long block, void* stream) {
  if (m <= 0) return 0;
  if ((n_keys != 1 && n_keys != 2) || n_vals < 0 || n_vals > MAX_COLUMNS || m >= (1LL << 30) ||
      n_scratch < scratch_words(m, n_keys) ||
      (block != 0 && (block < 2 * ITEMS || (block & (block - 1)) || m % block)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long run = block ? block : 1LL << 40;  // 0: one run of everything
  int* idx = scratch;
  int* tmp_ix = scratch + m;
  int* tmp0 = scratch + 2 * m;
  int* tmp1 = n_keys == 2 ? scratch + 3 * m : nullptr;
  const cudaError_t e =
      n_keys == 1
          ? sort_words<1>(k0_in, nullptr, k0_out, nullptr, idx, tmp0, nullptr, tmp_ix, m, run, st)
          : sort_words<2>(k0_in, k1_in, k0_out, k1_out, idx, tmp0, tmp1, tmp_ix, m, run, st);
  if (e != cudaSuccess) return (int)e;
  if (n_vals > 0)
    gather_columns<<<gather_blocks(m), GATHER_THREADS, 0, st>>>(
        idx, make_columns(vals_in, vals_out, n_vals), n_vals, m);
  return (int)cudaGetLastError();
}

// The plan of a call of egs_sort (the same m, block and n_keys): its merge
// levels after the CTA sort, so 1 + levels launches before the payload
// gather, and the int32 words of scratch it needs. The wrapper sizes its
// scratch by it; nothing else holds a copy.
extern "C" int egs_sort_plan(long long m, long long block, int n_keys, long long* levels,
                             long long* n_scratch) {
  if (m < 0 || block < 0 || (n_keys != 1 && n_keys != 2)) return (int)cudaErrorInvalidValue;
  *levels = merge_levels(m, block ? block : 1LL << 40);
  *n_scratch = scratch_words(m, n_keys);
  return 0;
}
