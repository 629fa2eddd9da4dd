// K7: bitonic sort of int32 keys (one word, or two compared
// lexicographically) carrying 32-bit payload columns.
//
// Replaces the Pallas kernels easygaussiansplatting_tpu/ops/pallas/sort.py
// `_local_kernel` (every stage with a distance below the block, in VMEM) and
// `_cross_kernel` (one stage between two blocks), reached through
// `sort_pairs` and `sort_blocks`. Plain version:
// ops/kernels/sort.py::sort_pairs_plain / sort_blocks_plain (a stable
// torch.sort and a gather).
//
// What bounds it on an H100: bytes at best (each key word and payload read
// once and written once); in practice the network's log2(m)^2 / 2 stages. At
// the gradient reduce's 557,056 keys (padded to 2^20) the three 4 MB work
// arrays (key words and a source index) stay in the 50 MB L2 between stages.
// The design keeps every stage it can on chip and moves only what it must:
//   * a CTA sorts BLOCK = 2048 entries in shared memory through every stage
//     whose distance is below BLOCK, one compare-exchange pair per thread;
//   * each merge round with seq > BLOCK runs one global pass per distance
//     j >= BLOCK (a thread per pair), then one shared-memory pass finishes
//     the round's j < BLOCK stages;
//   * the network moves the key words and a 32-bit source index only; one
//     gather at the end (columns.cuh) moves every payload column by that
//     index, so ten payload columns cost one pass, not one per stage.
// Directions follow the textbook network: (i & seq) == 0 is ascending, with
// i the global index for sort_pairs and the index inside each sorted block
// for sort_blocks (dir_mask = block - 1, the JAX `independent=True`).
//
// Ties between equal keys are broken by the source index, so the network
// orders unique (key words, index) tuples: the result is the stable sort,
// and the padding entries (pad_key, then INT32_MAX as a second word, index
// >= m) sort after every real entry. (The JAX kernel pads the second word
// with 0 and has no tie-break: there, dead patches keyed INT32_MAX mix with
// pads of the same key, which is harmless because callers read only live
// segments.)

#include <cuda_runtime.h>

#include "columns.cuh"

namespace {

constexpr int BLOCK = 2048;          // entries per CTA in the shared-memory passes
constexpr int THREADS = BLOCK / 2;   // one compare-exchange pair per thread and stage
constexpr int GLOBAL_THREADS = 256;

template <int NK>
__device__ __forceinline__ bool before(int a0, int a1, int ai, int b0, int b1, int bi) {
  if (a0 != b0) return a0 < b0;
  if (NK == 2 && a1 != b1) return a1 < b1;
  return ai < bi;
}

// Every stage with seq in [seq_from, seq_to] and distance below `block`, on
// `block` consecutive entries in shared memory. init: read the inputs (pads
// (pad_key, INT32_MAX) past m, index = position); else read the work arrays.
template <int NK>
__global__ void __launch_bounds__(THREADS)
bitonic_local(const int* __restrict__ in0, const int* __restrict__ in1,
              int* __restrict__ k0, int* __restrict__ k1, int* __restrict__ idx,
              long long m, int block, long long seq_from, long long seq_to,
              long long dir_mask, int init, int pad_key) {
  __shared__ int s0[BLOCK];
  __shared__ int s1[NK == 2 ? BLOCK : 1];
  __shared__ int si[BLOCK];
  const long long base = (long long)blockIdx.x * block;
  for (int t = threadIdx.x; t < block; t += blockDim.x) {
    const long long g = base + t;
    if (init) {
      const bool live = g < m;
      s0[t] = live ? in0[g] : pad_key;
      if (NK == 2) s1[t] = live ? in1[g] : 0x7fffffff;
      si[t] = (int)g;
    } else {
      s0[t] = k0[g];
      if (NK == 2) s1[t] = k1[g];
      si[t] = idx[g];
    }
  }
  __syncthreads();
  const int half = block >> 1;
  for (long long k = seq_from; k <= seq_to; k <<= 1) {
    for (int j = (int)(k >> 1 < half ? k >> 1 : half); j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i + j;
        const bool asc = (((base + i) & dir_mask) & k) == 0;
        const int a0 = s0[i], b0 = s0[p], ai = si[i], bi = si[p];
        const int a1 = NK == 2 ? s1[i] : 0, b1 = NK == 2 ? s1[p] : 0;
        const bool swap = asc ? before<NK>(b0, b1, bi, a0, a1, ai)
                              : before<NK>(a0, a1, ai, b0, b1, bi);
        if (swap) {
          s0[i] = b0;
          s0[p] = a0;
          si[i] = bi;
          si[p] = ai;
          if (NK == 2) {
            s1[i] = b1;
            s1[p] = a1;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < block; t += blockDim.x) {
    const long long g = base + t;
    k0[g] = s0[t];
    if (NK == 2) k1[g] = s1[t];
    idx[g] = si[t];
  }
}

// One stage at distance j >= BLOCK of the round `k`: a thread per pair.
template <int NK>
__global__ void __launch_bounds__(GLOBAL_THREADS)
bitonic_global(int* __restrict__ k0, int* __restrict__ k1, int* __restrict__ idx,
               long long pairs, long long j, long long k, long long dir_mask) {
  const long long t = (long long)blockIdx.x * GLOBAL_THREADS + threadIdx.x;
  if (t >= pairs) return;
  const long long i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  const long long p = i + j;
  const bool asc = ((i & dir_mask) & k) == 0;
  const int a0 = k0[i], b0 = k0[p], ai = idx[i], bi = idx[p];
  const int a1 = NK == 2 ? k1[i] : 0, b1 = NK == 2 ? k1[p] : 0;
  const bool swap = asc ? before<NK>(b0, b1, bi, a0, a1, ai)
                        : before<NK>(a0, a1, ai, b0, b1, bi);
  if (swap) {
    k0[i] = b0;
    k0[p] = a0;
    idx[i] = bi;
    idx[p] = ai;
    if (NK == 2) {
      k1[i] = b1;
      k1[p] = a1;
    }
  }
}

template <int NK>
void network(const int* k0_in, const int* k1_in, int* k0w, int* k1w, int* idxw, long long m,
             long long m_pad, long long seq_max, long long dir_mask, int pad_key,
             cudaStream_t s) {
  const int block = (int)(seq_max < BLOCK ? seq_max : BLOCK);
  const int threads = block / 2;
  const unsigned n_blocks = (unsigned)(m_pad / block);
  const long long pairs = m_pad / 2;
  const unsigned g_blocks = (unsigned)((pairs + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  bitonic_local<NK><<<n_blocks, threads, 0, s>>>(k0_in, k1_in, k0w, k1w, idxw, m, block, 2,
                                                 block, dir_mask, 1, pad_key);
  for (long long seq = 2LL * block; seq <= seq_max; seq <<= 1) {
    for (long long j = seq >> 1; j >= block; j >>= 1)
      bitonic_global<NK><<<g_blocks, GLOBAL_THREADS, 0, s>>>(k0w, k1w, idxw, pairs, j, seq,
                                                             dir_mask);
    bitonic_local<NK><<<n_blocks, threads, 0, s>>>(nullptr, nullptr, k0w, k1w, idxw, m, block,
                                                   seq, seq, dir_mask, 0, pad_key);
  }
}

}  // namespace

// Sorts m entries by (k0[, k1]) ascending, ties by position.
//   k0_in, k1_in: [m] int32 key words (k1_in null when n_keys == 1);
//   vals_in, vals_out: host arrays of n_vals device pointers to [m] 32-bit
//     payload columns, in and out;
//   k0w, k1w, idxw: [m_pad] int32 device work arrays; on return their first m
//     entries hold the sorted key words and each entry's source index;
//   m_pad: a multiple of seq_max with m <= m_pad; seq_max: a power of two,
//     the length of each sorted run (m_pad for one sort of everything);
//   dir_mask: -1 for one sort, seq_max - 1 for independent runs;
//   pad_key: key word 0 of the entries past m (>= every real key).
extern "C" int egs_sort(const int* k0_in, const int* k1_in, int n_keys,
                        const void* const* vals_in, void* const* vals_out, int n_vals,
                        int* k0w, int* k1w, int* idxw, long long m, long long m_pad,
                        long long seq_max, long long dir_mask, int pad_key, void* stream) {
  if (m <= 0) return 0;
  if ((n_keys != 1 && n_keys != 2) || n_vals < 0 || n_vals > MAX_COLUMNS || seq_max < 2 ||
      (seq_max & (seq_max - 1)) || m_pad < m || m_pad % seq_max)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_keys == 1)
    network<1>(k0_in, nullptr, k0w, nullptr, idxw, m, m_pad, seq_max, dir_mask, pad_key, s);
  else
    network<2>(k0_in, k1_in, k0w, k1w, idxw, m, m_pad, seq_max, dir_mask, pad_key, s);
  if (n_vals > 0)
    gather_columns<<<gather_blocks(m), GATHER_THREADS, 0, s>>>(
        idxw, make_columns(vals_in, vals_out, n_vals), n_vals, m);
  return (int)cudaGetLastError();
}
