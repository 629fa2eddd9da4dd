// K3: multi-row inclusive cumulative sum (int32 or float32) in one launch,
// the carry by a look-back over the earlier tiles' aggregates.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/scan.py
// `_scan_kernel` (reached through `multi_cumsum` and `batched_cumsum`), which
// walks lane blocks in order on the TPU's one core and carries a running
// total in VMEM scratch. Plain version: torch.cumsum along axis 1 with the
// input's dtype kept (ops/kernels/scan.py::multi_cumsum_plain).
//
// What bounds it on an H100: bytes. One read and one write of 4 bytes an
// element against one add: binning's three calls a render ([2, 229,376],
// [1, 229,376], [2, 557,056]) move 14.4 MB, 0.0043 ms at 3.35 TB/s, so at
// these sizes a call is mostly its launch and the carry's wait. Blocks run
// in no order on 132 SMs, so the carry across blocks cannot ride in scratch
// from one grid step to the next as on the TPU. The design:
//   * One launch a call, after one cudaMemsetAsync that clears the tile
//     counter and the tiles' status words (egs_multi_cumsum_plan counts
//     both). A block owns a tile of TILE = 4,096 positions of one row and
//     takes its tile index (rows in order, tiles in order within a row) from
//     an atomic counter, so every tile it waits on is held by a block that
//     already runs.
//   * The tile arrives in shared memory by 16-byte cp.async, consecutive
//     lanes on consecutive addresses. Thread t then owns the ITEMS = 16
//     consecutive elements of its shared row (rows padded to 20 words, an
//     odd number of 16-byte units, so a warp's 16-byte reads of its rows are
//     conflict-free): a serial scan of the 16, a 5-step shuffle scan of the
//     thread totals across the warp, the 8 warp totals added in order.
//     The results go back through the same rows and leave by 16-byte
//     stores. A length that is not a multiple of 4, or a pointer that is not
//     16-byte aligned, takes striped 4-byte loads and stores instead, as
//     coalesced.
//   * Across tiles, a look-back over every earlier tile of the row. A tile
//     publishes its aggregate at once as one 64-bit word (a ready flag in
//     the high half, the value's bits in the low half) by a release store;
//     its threads then read the earlier tiles' words by acquire loads, a
//     tile a thread, and sum them in a fixed order (each thread its tiles
//     in order, a fixed tree across the warp, the warps in order), so two
//     float32 calls are bit-equal. No tile publishes an inclusive value
//     and none waits on another's carry: at binning's sizes every tile of
//     a call is resident at once, all aggregates appear together, and a
//     chained look-back (as K6's, csrc/seg_scan.cu) would walk up to 135
//     tiles back to tile 0 and fold them one by one; here the longest
//     wait is one round of reads. The reads grow as tiles^2 / 2 a row (9
//     K words at binning's longest rows, 134 M at 2^26 positions), all L2
//     hits spread over the block's threads; a look-back that stops at the
//     nearest inclusive prefix reads fewer, but makes a tile wait on the
//     carries of the tiles before it, and was the slower of the two at
//     every length up to 2^26 (PERF.md).
//   * Words from an earlier call are never read: the memset clears them
//     before the launch, on the same stream.
//   * int32 runs in unsigned arithmetic: two's-complement wrap, as
//     torch.cumsum(..., dtype=torch.int32) gives it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "memory_order.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;              // consecutive elements a thread
constexpr int TILE = THREADS * ITEMS;  // positions a block
constexpr int ROW = ITEMS + 4;         // a thread's shared row in words: 5 16-byte units
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_READY = 1u;      // status (high half of a word): the aggregate is there

__device__ __forceinline__ unsigned bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }
template <typename V>
__device__ __forceinline__ V from_bits(unsigned b);
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned b) { return b; }
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) { return __uint_as_float(b); }

// element e of a tile -> its word in shared memory
__device__ __forceinline__ int slot(int e) { return e / ITEMS * ROW + e % ITEMS; }

// V: unsigned (int32 bits) or float. VEC: m % 4 == 0 and x, y 16-byte
// aligned. counter and status [rows * tiles_per_row] start at 0.
template <typename V, bool VEC>
__global__ void __launch_bounds__(THREADS)
multi_scan_kernel(const V* __restrict__ x, V* __restrict__ y, long long m,
                  unsigned tiles_per_row, unsigned* counter, unsigned long long* status) {
  __shared__ __align__(16) V s_rows[THREADS * ROW];
  __shared__ V s_warp[WARPS];  // warp totals
  __shared__ V s_part[WARPS];  // the warps' parts of the carry
  __shared__ unsigned s_tile_idx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_tile_idx = atomicAdd(counter, 1u);
  __syncthreads();
  const unsigned row = s_tile_idx / tiles_per_row, tile = s_tile_idx % tiles_per_row;
  const long long base = (long long)tile * TILE;
  const V* xt = x + row * m + base;
  V* yt = y + row * m + base;
  const int count = (int)(m - base < TILE ? m - base : TILE);

  if (VEC) {
    for (int q = tid; q < count / 4; q += THREADS) cp_async16(&s_rows[slot(4 * q)], xt + 4 * q);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int e = tid; e < count; e += THREADS) s_rows[slot(e)] = xt[e];
  }
  __syncthreads();

  // the thread's elements, scanned; positions past m hold 0
  V* mine = s_rows + tid * ROW;
  V v[ITEMS];
#pragma unroll
  for (int j4 = 0; j4 < ITEMS / 4; ++j4) {
    const uint4 w = reinterpret_cast<const uint4*>(mine)[j4];
    v[4 * j4] = from_bits<V>(w.x);
    v[4 * j4 + 1] = from_bits<V>(w.y);
    v[4 * j4 + 2] = from_bits<V>(w.z);
    v[4 * j4 + 3] = from_bits<V>(w.w);
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (tid * ITEMS + i >= count) v[i] = V(0);
    if (i > 0) v[i] = v[i - 1] + v[i];
  }
  V a = v[ITEMS - 1];
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const V up = __shfl_up_sync(FULL, a, s);
    if (lane >= s) a = up + a;
  }
  V ex = __shfl_up_sync(FULL, a, 1);  // the warp's earlier threads
  if (lane == 0) ex = V(0);
  if (lane == 31) s_warp[warp] = a;
  __syncthreads();

  // the earlier warps' sum and the tile's aggregate, in warp order (the
  // same adds in every thread); thread 0 publishes the aggregate at once
  V wpre = V(0), agg = V(0);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) wpre = agg;
    agg = agg + s_warp[w];
  }
  unsigned long long* st = status + (unsigned long long)row * tiles_per_row;
  if (tid == 0) store_release(st + tile, (unsigned long long)ST_READY << 32 | bits(agg));

  // the carry: every earlier tile's aggregate, thread i summing tiles i,
  // i + THREADS, ... in order, then a fixed tree across the warp and the
  // warps' sums in order. Every earlier tile publishes without waiting, so
  // each spin ends.
  V part = V(0);
  for (unsigned j = tid; j < tile; j += THREADS) {
    unsigned long long w;
    do {
      w = load_acquire(st + j);
    } while ((unsigned)(w >> 32) != ST_READY);
    part = part + from_bits<V>((unsigned)w);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) part = part + __shfl_xor_sync(FULL, part, s);
  if (lane == 0) s_part[warp] = part;
  __syncthreads();
  V carry = V(0);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) carry = carry + s_part[w];

  const V pre = carry + wpre + ex;
#pragma unroll
  for (int j4 = 0; j4 < ITEMS / 4; ++j4)
    reinterpret_cast<uint4*>(mine)[j4] =
        make_uint4(bits(pre + v[4 * j4]), bits(pre + v[4 * j4 + 1]),
                   bits(pre + v[4 * j4 + 2]), bits(pre + v[4 * j4 + 3]));
  __syncthreads();
  if (VEC) {
    for (int q = tid; q < count / 4; q += THREADS)
      reinterpret_cast<uint4*>(yt)[q] = *reinterpret_cast<const uint4*>(&s_rows[slot(4 * q)]);
  } else {
    for (int e = tid; e < count; e += THREADS) yt[e] = s_rows[slot(e)];
  }
}

struct Plan {
  long long tiles_per_row, n_tiles, scratch_words;
};

Plan make_plan(long long m, int rows) {
  Plan p;
  p.tiles_per_row = (m + TILE - 1) / TILE;
  p.n_tiles = rows > 0 ? rows * p.tiles_per_row : 0;
  // the tile counter (padded to 8 bytes), then a 64-bit status word a tile
  p.scratch_words = p.n_tiles ? 2 + 2 * p.n_tiles : 0;
  return p;
}

template <typename V>
int multi_cumsum(const V* x, V* y, int* scratch, long long n_scratch, int rows, long long m,
                 void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const Plan plan = make_plan(m, rows);
  if (n_scratch < plan.scratch_words || plan.n_tiles > 0x7fffffffLL || !aligned(scratch, 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(scratch, 0, plan.scratch_words * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 2);
  const bool vec = m % 4 == 0 && aligned(x, 16) && aligned(y, 16);
  if (vec)
    multi_scan_kernel<V, true><<<(unsigned)plan.n_tiles, THREADS, 0, s>>>(
        x, y, m, (unsigned)plan.tiles_per_row, counter, status);
  else
    multi_scan_kernel<V, false><<<(unsigned)plan.n_tiles, THREADS, 0, s>>>(
        x, y, m, (unsigned)plan.tiles_per_row, counter, status);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows, m] contiguous device arrays; scratch: int32 words of device
// memory, 8-byte aligned, as many as egs_multi_cumsum_plan gives (checked
// here), left uninitialised by the caller.
extern "C" int egs_multi_cumsum_i32(const int32_t* x, int32_t* y, int* scratch,
                                    long long n_scratch, int rows, long long m, void* stream) {
  return multi_cumsum<unsigned>(reinterpret_cast<const unsigned*>(x),
                                reinterpret_cast<unsigned*>(y), scratch, n_scratch, rows, m,
                                stream);
}

extern "C" int egs_multi_cumsum_f32(const float* x, float* y, int* scratch, long long n_scratch,
                                    int rows, long long m, void* stream) {
  return multi_cumsum<float>(x, y, scratch, n_scratch, rows, m, stream);
}

// The plan of a call of egs_multi_cumsum_* on [rows, m]: positions a tile,
// kernel launches (one), memsets (one, clearing the tile counter and the
// status words) and int32 words of scratch. The wrapper sizes its scratch
// by it; nothing else holds a copy.
extern "C" int egs_multi_cumsum_plan(long long m, int rows, long long* tile, long long* launches,
                                     long long* memsets, long long* n_scratch) {
  if (m < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(m, rows);
  *tile = TILE;
  *launches = plan.n_tiles > 0;
  *memsets = plan.n_tiles > 0;
  *n_scratch = plan.scratch_words;
  return 0;
}
