// K6: multi-row inclusive segmented sum (float32), restarting at flagged
// segment starts shared by all rows, in one launch with decoupled look-back.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/scan.py
// `_seg_scan_kernel` (reached through `segmented_cumsum` from the gradient
// reduce `_sort_reduce_grads`), which walks lane blocks in order on the TPU's
// one core and carries the open segment's running sum in VMEM scratch.
// Plain version: ops/kernels/scan.py::segmented_cumsum_plain (a float64
// cumsum minus the running total at each segment start).
//
// What bounds it on an H100: bytes. Each value is read once and written once
// and the shared flag word is read once: 76 B a position for the reduce's 9
// rows, ~42 MB at 557,056 positions, against one add an element. Blocks run
// in no order on 132 SMs, so the carry across blocks cannot ride in scratch
// from one grid step to the next as on the TPU. The design:
//   * One launch; a block owns a tile of TILE = 1,024 positions for all rows
//     (up to GROUP_ROWS = 16; more rows take one launch a group). Its thread
//     t owns positions 4t..4t+3, so the flags arrive as one 16-byte load a
//     thread, are read once a tile and serve every row from registers; the
//     rows arrive by 16-byte cp.async into shared memory and leave by
//     16-byte stores, consecutive lanes on consecutive addresses (lengths
//     that are not a multiple of 4 or pointers that are not 16-byte aligned
//     take striped 4-byte accesses instead, as coalesced).
//   * Inside the tile: a serial scan of the thread's 4 positions, a 5-step
//     shuffle scan across the warp (the flags' part of it is computed once,
//     as a mask, for all rows), and one warp's scan of the 8 warp aggregates
//     a row.
//   * Across tiles, a single-pass carry by decoupled look-back: a block takes
//     its tile index from an atomic counter, so every tile it waits on is
//     held by a block that already runs. Each tile publishes its aggregate
//     (the sum after its last start, or all of it) at once, with a release
//     store of its status word after the values. A tile that holds a start
//     publishes it as its inclusive value; a tile with none publishes it as
//     an aggregate and, once it knows the value carried in, its inclusive
//     value: carried + aggregate. The value carried into tile t is the
//     inclusive value of tile t - 1, found by reading back to the nearest
//     tile with an inclusive value and folding the aggregates after it left
//     to right. That is the chain's own sum: inclusive(j) is by definition
//     inclusive(j - 1) + aggregate(j), the same adds in the same order
//     whichever inclusive value the walk meets, so every sum runs in one
//     order on every run and two calls are bit-equal. Aggregates and
//     inclusive values are never combined in the order they arrive.
//   * The carry reaches exactly the positions before the tile's first start
//     (the TPU kernel's round-3 carry bug sat at this boundary), and element
//     0 always starts a segment, so tile 0 never waits.
//   * The tile counters and status words start each call at 0 by one
//     cudaMemsetAsync of the scratch's head in the C entry (a memset, not a
//     kernel: egs_segmented_cumsum_plan counts it apart from the launches).
//     The value words need no initialising: a status word is released only
//     after the values it covers.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "memory_order.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS * 4;  // positions a block: one float4 a thread a row
constexpr int GROUP_ROWS = 16;     // rows a launch
constexpr int LOOKBACK = 32;       // earlier tiles a look-back step reads at once
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_AGGREGATE = 1u;  // the tile's aggregate is published
constexpr unsigned ST_INCLUSIVE = 2u;  // the tile's inclusive value is published

// One launch over `rows` (<= GROUP_ROWS) rows of length m. VEC: m % 4 == 0
// and x, y, flags 16-byte aligned. counter and status [n_tiles] start at 0;
// aggs and incls hold [n_tiles][rows] floats each.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
seg_scan_kernel(const float* __restrict__ x, const int* __restrict__ flags,
                float* __restrict__ y, int rows, long long m, unsigned* counter,
                unsigned* status, float* aggs, float* incls) {
  extern __shared__ float4 s_vals[];           // [rows][THREADS]: a thread's 4 positions
  __shared__ float s_warp[GROUP_ROWS][WARPS];  // warp aggregates, then their exclusive prefixes
  __shared__ int s_warp_start[WARPS];          // a start in warp w
  __shared__ float s_tile[GROUP_ROWS];         // the tile's aggregate
  __shared__ float s_carry[GROUP_ROWS];        // the value carried in: inclusive(tile - 1)
  __shared__ float s_look[LOOKBACK][GROUP_ROWS + 1];
  __shared__ long long s_tile_idx;
  __shared__ int s_first_start;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* sv = reinterpret_cast<float*>(s_vals);

  if (tid == 0) s_tile_idx = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = s_tile_idx;
  const long long base = tile * TILE;
  const long long p0 = base + 4 * tid;  // the thread's first position

  // stage the rows; positions past m hold the identity (0, no start)
  if (VEC) {
    for (int r = 0; r < rows; ++r) {
      if (p0 < m)
        cp_async16(&s_vals[r * THREADS + tid], x + r * m + p0);
      else
        s_vals[r * THREADS + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    cp_async_commit();
  } else {
    for (int r = 0; r < rows; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long q = base + e * THREADS + tid;
        sv[r * TILE + e * THREADS + tid] = q < m ? x[r * m + q] : 0.0f;
      }
  }
  int f[4];
  if (VEC) {
    const int4 fv = p0 < m ? *reinterpret_cast<const int4*>(flags + p0) : make_int4(0, 0, 0, 0);
    f[0] = fv.x, f[1] = fv.y, f[2] = fv.z, f[3] = fv.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = p0 + e < m ? flags[p0 + e] : 0;
  }
  if (p0 == 0) f[0] = 1;  // element 0 always starts a segment
  bool cum[4];            // a start among the thread's positions up to e
  cum[0] = f[0] != 0;
#pragma unroll
  for (int e = 1; e < 4; ++e) cum[e] = cum[e - 1] || f[e] != 0;
  if (tid == 0) s_first_start = cum[0];

  // the flags' part of the warp scan, for all rows: bit s of `take` says
  // whether step s adds the value from 2^s lanes below
  int fl = cum[3];
  unsigned take = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int up = __shfl_up_sync(FULL, fl, 1 << s);
    if (lane >= (1 << s)) {
      if (!fl) take |= 1u << s;
      fl |= up;
    }
  }
  int start_before = __shfl_up_sync(FULL, fl, 1);  // a start in the warp's earlier lanes
  if (lane == 0) start_before = 0;
  if (lane == 31) s_warp_start[warp] = fl;
  if (VEC) cp_async_wait<0>();
  __syncthreads();

  // each row: the thread's positions, then across the warp
  for (int r = 0; r < rows; ++r) {
    float4 v = s_vals[r * THREADS + tid];
    if (!f[1]) v.y = v.x + v.y;
    if (!f[2]) v.z = v.y + v.z;
    if (!f[3]) v.w = v.z + v.w;
    float a = v.w;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const float up = __shfl_up_sync(FULL, a, 1 << s);
      if (take >> s & 1u) a = up + a;
    }
    const float ex = __shfl_up_sync(FULL, a, 1);
    if (lane == 31) s_warp[r][warp] = a;
    if (lane > 0) {
      if (!cum[0]) v.x = ex + v.x;
      if (!cum[1]) v.y = ex + v.y;
      if (!cum[2]) v.z = ex + v.z;
      if (!cum[3]) v.w = ex + v.w;
    }
    s_vals[r * THREADS + tid] = v;
  }
  __syncthreads();

  int tile_start = 0, warp_start_before = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    tile_start |= s_warp_start[w];
    if (w < warp) warp_start_before |= s_warp_start[w];
  }
  const bool need_carry = !s_first_start;  // positions before the tile's first start
  if (warp == 0) {
    // the warps' exclusive prefixes and the tile's aggregate, a lane a row
    if (lane < rows) {
      float run = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        const float a = s_warp[lane][w];
        s_warp[lane][w] = run;
        run = s_warp_start[w] ? a : run + a;
      }
      s_tile[lane] = run;
      s_carry[lane] = 0.0f;
    }
    __syncwarp();
    if (lane == 0) {
      float* slot = (tile_start ? incls : aggs) + tile * rows;
      for (int r = 0; r < rows; ++r) slot[r] = s_tile[r];
      store_release(status + tile, tile_start ? ST_INCLUSIVE : ST_AGGREGATE);
    }
    if (need_carry) {  // so tile > 0
      // back to the nearest tile with an inclusive value; every earlier
      // tile publishes something without waiting, so the spin ends
      long long k = tile - 1, stop;
      for (;;) {
        const long long j = k - lane;
        unsigned st = ST_INCLUSIVE;  // below tile 0, never reached: tile 0 is inclusive
        if (j >= 0) {
          do {
            st = load_acquire(status + j);
          } while (st == 0u);
        }
        const unsigned ball = __ballot_sync(FULL, st == ST_INCLUSIVE);
        if (ball) {
          stop = k - (__ffs(ball) - 1);
          break;
        }
        k -= LOOKBACK;
      }
      // inclusive(tile - 1): fold left from inclusive(stop)
      float acc = 0.0f;
      for (long long j0 = stop; j0 < tile; j0 += LOOKBACK) {
        const long long j = j0 + lane;
        if (j < tile) {
          load_acquire(status + j);  // orders this lane's value loads after the publish
          const float* src = (j == stop ? incls : aggs) + j * rows;
          for (int r = 0; r < rows; ++r) s_look[lane][r] = load_relaxed(src + r);
        }
        __syncwarp();
        if (lane < rows) {
          const int cnt = (int)(tile - j0 < LOOKBACK ? tile - j0 : LOOKBACK);
          for (int u = 0; u < cnt; ++u)
            acc = j0 + u == stop ? s_look[u][lane] : acc + s_look[u][lane];
        }
        __syncwarp();
      }
      if (lane < rows) s_carry[lane] = acc;
      __syncwarp();
      if (!tile_start && lane == 0) {
        for (int r = 0; r < rows; ++r) incls[tile * rows + r] = s_carry[r] + s_tile[r];
        store_release(status + tile, ST_INCLUSIVE);
      }
    }
  }
  __syncthreads();

  // the block's prefix reaches the positions with no start before them in
  // the tile: the carry plus the earlier warps' sum, or that sum alone
  for (int r = 0; r < rows; ++r) {
    float4 v = s_vals[r * THREADS + tid];
    if (!start_before) {
      const float pre = warp_start_before ? s_warp[r][warp] : s_carry[r] + s_warp[r][warp];
      if (!cum[0]) v.x = pre + v.x;
      if (!cum[1]) v.y = pre + v.y;
      if (!cum[2]) v.z = pre + v.z;
      if (!cum[3]) v.w = pre + v.w;
    }
    if (VEC) {
      if (p0 < m) *reinterpret_cast<float4*>(y + r * m + p0) = v;
    } else {
      s_vals[r * THREADS + tid] = v;
    }
  }
  if (!VEC) {
    __syncthreads();
    for (int r = 0; r < rows; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long q = base + e * THREADS + tid;
        if (q < m) y[r * m + q] = sv[r * TILE + e * THREADS + tid];
      }
  }
}

struct Plan {
  long long n_tiles, groups, head_words, scratch_words;
};

Plan make_plan(long long m, int rows) {
  Plan p;
  p.n_tiles = (m + TILE - 1) / TILE;
  p.groups = m > 0 && rows > 0 ? (rows + GROUP_ROWS - 1) / GROUP_ROWS : 0;
  // per group a tile counter and the tiles' status words; then per row and
  // tile an aggregate and an inclusive value
  p.head_words = p.groups * (1 + p.n_tiles);
  p.scratch_words = p.groups ? p.head_words + 2 * p.n_tiles * rows : 0;
  return p;
}

}  // namespace

// x, y: [rows, m] float32 contiguous device arrays; flags [m] int32 (nonzero
// starts a segment; element 0 always does). scratch: int32 words of device
// memory, as many as egs_segmented_cumsum_plan gives (checked here), left
// uninitialised by the caller.
extern "C" int egs_segmented_cumsum_f32(const float* x, const int* flags, float* y,
                                        int* scratch, long long n_scratch, int rows,
                                        long long m, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const Plan plan = make_plan(m, rows);
  if (n_scratch < plan.scratch_words || plan.n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool attributes_set = false;
  if (!attributes_set) {
    const int most = GROUP_ROWS * TILE * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(seg_scan_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(seg_scan_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    attributes_set = true;
  }
  const bool vec = m % 4 == 0 && aligned(x, 16) && aligned(y, 16) && aligned(flags, 16);
  unsigned* head = reinterpret_cast<unsigned*>(scratch);
  float* vals = reinterpret_cast<float*>(scratch + plan.head_words);
  cudaError_t e = cudaMemsetAsync(head, 0, plan.head_words * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  for (long long g = 0; g < plan.groups; ++g) {
    const int row0 = (int)g * GROUP_ROWS;
    const int rg = rows - row0 < GROUP_ROWS ? rows - row0 : GROUP_ROWS;
    unsigned* counter = head + g * (1 + plan.n_tiles);
    float* aggs = vals + 2 * plan.n_tiles * row0;
    float* incls = aggs + plan.n_tiles * rg;
    const size_t smem = (size_t)rg * TILE * sizeof(float);
    if (vec)
      seg_scan_kernel<true><<<(unsigned)plan.n_tiles, THREADS, smem, s>>>(
          x + row0 * m, flags, y + row0 * m, rg, m, counter, counter + 1, aggs, incls);
    else
      seg_scan_kernel<false><<<(unsigned)plan.n_tiles, THREADS, smem, s>>>(
          x + row0 * m, flags, y + row0 * m, rg, m, counter, counter + 1, aggs, incls);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

// The plan of a call of egs_segmented_cumsum_f32 on [rows, m]: positions a
// tile, kernel launches (one a group of 16 rows), memsets (one, clearing
// the tile counters and status words) and int32 words of scratch. The
// wrapper sizes its scratch by it; nothing else holds a copy.
extern "C" int egs_segmented_cumsum_plan(long long m, int rows, long long* tile,
                                         long long* launches, long long* memsets,
                                         long long* n_scratch) {
  if (m < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(m, rows);
  *tile = TILE;
  *launches = plan.groups;
  *memsets = plan.groups > 0;
  *n_scratch = plan.scratch_words;
  return 0;
}
