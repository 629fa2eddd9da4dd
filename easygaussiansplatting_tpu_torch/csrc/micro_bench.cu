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
// (19.25 MB) and B writes [n_tiles, 3, 256] plus tau [n_tiles, 256]
// (8.89 MB).
//
// Designs. The TPU grid runs in order on one core; here blocks run in no
// order on 132 SMs, so nothing may carry from one block to the next. A tile's
// chunks are found in the non-decreasing `tiles` by search and summed in a
// fixed order, so a tile that no chunk visits comes out zero (B's TPU output
// is undefined there: it initialises only tiles[0]'s block) and every sum is
// deterministic, with no atomics.
//   A: one block per chunk copies its 16 KB into shared memory with cp.async
//      (async_copy.cuh: volatile PTX, so the loads that nothing reads stay);
//      block 0 writes the zeros.
//   B: a warp per tile, each its own block (2,170 blocks of 32 threads at the
//      script's size, up to 22 an SM by shared memory: one wave). As a
//      256-thread block per tile its time was latency: 3 waves, each behind
//      a 13-step binary search, then scalar loads one chunk at a time. Now:
//      * the warp finds its range by V's 128-ary search (`tile_range`);
//      * lane 0 stages each chunk's rows 0-2 (three 1 KB rows) by three TMA
//        bulk copies (tma.cuh) into a ring of 3 slots of 3 KB, each with a
//        "full" mbarrier: the first 3 chunks at once, then each slot again
//        as soon as the warp has read it (a __syncwarp, fence.proxy.async),
//        so 9 KB a tile are in flight and no register holds them. The k-th
//        use of a slot waits on parity k & 1, which wraps from its third
//        use on (tiles of 7 chunks and more);
//      * lane l adds pixels 4l..4l+3 and 128+4l..+3 of each row in chunk
//        order, as the plain version does, so img is bit-equal to it; then
//        it stores 6 float4 of img and 2 of tau, 512 contiguous bytes a
//        warp-wide store.
//      Kept over the same warp reading its chunks into registers, 2 or 3 at
//      a time (float4 loads with predication at the range's end): that was
//      faster with the L2 warm, slower from device memory.
//   V: a warp per tile, 8 tiles a block (272 blocks at the script's 2,170
//      tiles: one wave at 3 blocks an SM). Its time was latency: a block per
//      tile ran 3 waves, each behind a 13-step binary search and scalar
//      loads. Now:
//      * the warp finds both ends of its tile's range together by a 128-ary
//        search (`tile_range`): each round a lane reads 4 evenly spaced
//        `tiles` entries for each end and the warp counts those below the
//        tile by __ballot_sync and __popc, so q = 6,266 takes 2 dependent
//        rounds (q up to 16,512 does); the range stays inside [0, q]
//        whatever the values;
//      * it then reads rows 0-2 of its chunks as float4, two chunks at a
//        time (6 float4 a lane a chunk, 12 in flight), with predication at
//        the range's end;
//      * sums in a fixed tree: a lane's 8 values of a row in 3 levels, the
//        chunks pairwise in groups of 8 (3 levels), the groups in order, the
//        32 lanes by a 5-step xor shuffle. A tile of n chunks has rounding
//        depth 3 + 3 + (ceil(n / 8) - 1) + 5: 12 at the script's at most 9
//        chunks, 15 at 40.

#include <cuda_runtime.h>

#include <climits>

#include "async_copy.cuh"
#include "memory_order.cuh"
#include "tma.cuh"

namespace {

constexpr int ROWS = 16;     // rows of `packed`
constexpr int K = 256;       // columns of a chunk: one tile's pixels
constexpr int THREADS = 256;

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

constexpr int V_WARPS = 8;                  // tiles a block
constexpr int V_THREADS = 32 * V_WARPS;
constexpr int PROBES = 4;                   // `tiles` entries a lane reads a round, per end
constexpr int FAN = 32 * PROBES;            // the search's fan-out
constexpr int GROUP = 8;                    // chunks summed as one tree

// One round of the warp's search for the first chunk whose tile is >= t in
// [lo, hi): FAN probes split the range into FAN + 1 parts (one probe a
// position once it holds at most FAN), and the count of probes below t
// narrows it to one part. The probes below t form a prefix when `tiles` is
// non-decreasing; for any values lo and hi stay in [0, q] and the range
// shrinks every round.
struct Search {
  int lo, hi, step;
  __device__ __forceinline__ void probe(const int* __restrict__ tiles, int lane,
                                        int (&v)[PROBES]) {
    step = max(1, (hi - lo + FAN - 1) / FAN);
#pragma unroll
    for (int j = 0; j < PROBES; ++j) {
      const long long idx = lo + (long long)(32 * j + lane + 1) * step - 1;
      v[j] = idx < hi ? __ldg(tiles + idx) : INT_MAX;
    }
  }
  __device__ __forceinline__ void narrow(int t, const int (&v)[PROBES]) {
    int k = 0;
#pragma unroll
    for (int j = 0; j < PROBES; ++j) k += __popc(__ballot_sync(0xffffffffu, v[j] < t));
    const int nlo = (int)min((long long)lo + (long long)k * step, (long long)hi);
    hi = max(nlo, (int)min((long long)hi, (long long)lo + (long long)(k + 1) * step - 1));
    lo = nlo;
  }
};

// [start, end): tile t's chunks in the non-decreasing tiles[0..q), found by
// the whole warp (every lane gets the same range).
__device__ __forceinline__ void tile_range(const int* __restrict__ tiles, int q, int t, int lane,
                                           int& start, int& end) {
  Search a{0, q, 1}, b{0, q, 1};  // the first chunk of tile t, and of t + 1
  while (a.hi > a.lo || b.hi > b.lo) {
    int va[PROBES], vb[PROBES];
    a.probe(tiles, lane, va);
    b.probe(tiles, lane, vb);
    a.narrow(t, va);
    b.narrow(t + 1, vb);
  }
  start = a.lo;
  end = max(b.lo, a.lo);
}

__device__ __forceinline__ float lane_sum(const float4& a, const float4& b) {
  return ((a.x + b.x) + (a.y + b.y)) + ((a.z + b.z) + (a.w + b.w));
}

// s[r] = this lane's sum of row r over chunks c and c + 1 (a chunk at or past
// `end` adds 0); p points at packed + 4 * lane.
__device__ __forceinline__ void pair_sums(const float* __restrict__ p, long long ld, int c,
                                          int end, float (&s)[3]) {
  float4 v[2][3][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const bool ok = c + u < end;
    const float* src = p + (long long)(c + u) * K;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[u][r][h] = ok ? __ldg(reinterpret_cast<const float4*>(src + r * ld + h * (K / 2)))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s[r] = lane_sum(v[0][r][0], v[0][r][1]) + lane_sum(v[1][r][0], v[1][r][1]);
  }
}

// V: warp w of block b sums tile 8b + w into out[t, 0..2].
__global__ void __launch_bounds__(V_THREADS, 3)
tile_totals_kernel(const float* __restrict__ packed, long long ld,
                   const int* __restrict__ tiles, int q, int n_tiles, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * V_WARPS + (threadIdx.x >> 5);
  if (t >= n_tiles) return;  // the whole warp
  int start, end;
  tile_range(tiles, q, t, lane, start, end);
  const float* p = packed + 4 * lane;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int g = start; g < end; g += GROUP) {
    float s0[3], s1[3], s2[3] = {0.f, 0.f, 0.f}, s3[3] = {0.f, 0.f, 0.f};
    pair_sums(p, ld, g, end, s0);
    pair_sums(p, ld, g + 2, end, s1);
    if (g + 4 < end) {
      pair_sums(p, ld, g + 4, end, s2);
      pair_sums(p, ld, g + 6, end, s3);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) acc[r] += (s0[r] + s1[r]) + (s2[r] + s3[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < 3; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  if (lane < 3) out[(long long)t * 3 + lane] = lane == 0 ? acc[0] : lane == 1 ? acc[1] : acc[2];
}

constexpr int B_SLOTS = 3;  // chunks a warp holds in flight, 3 KB each
// blocks an SM: as many as shared memory holds (9 KB and 1 KB reserved each)
constexpr int B_BLOCKS_PER_SM = 22;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// B: block t, one warp, adds rows 0-2 of tile t's chunks into img[t] in chunk
// order and fills tau[t] with ones.
__global__ void __launch_bounds__(32, B_BLOCKS_PER_SM)
tile_sums_kernel(const float* __restrict__ packed, long long ld,
                 const int* __restrict__ tiles, int q, float* __restrict__ img,
                 float* __restrict__ tau) {
  __shared__ __align__(128) float ring[B_SLOTS][3 * K];
  __shared__ uint64_t full[B_SLOTS];
  const int lane = threadIdx.x, t = blockIdx.x;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < B_SLOTS; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncwarp();
  int start, end;
  tile_range(tiles, q, t, lane, start, end);
  const int n = end - start;
  // chunk start + i into slot i % B_SLOTS, its three rows counted off that
  // slot's barrier
  auto fill = [&](int i) {
    const int s = i % B_SLOTS;
    mbar_arrive_expect_tx(&full[s], 3 * K * sizeof(float));
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      bulk_copy_g2s(ring[s] + r * K, packed + r * ld + (long long)(start + i) * K,
                    K * sizeof(float), &full[s]);
    }
  };
  if (lane == 0) {
    for (int i = 0; i < min(n, B_SLOTS); ++i) fill(i);
  }
  float4 acc[3][2];
#pragma unroll
  for (int r = 0; r < 3; ++r) acc[r][0] = acc[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const int s = i % B_SLOTS;
    mbar_wait(&full[s], (i / B_SLOTS) & 1);
    const float4* b = reinterpret_cast<const float4*>(ring[s]) + lane;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      add4(acc[r][0], b[r * (K / 4)]);
      add4(acc[r][1], b[r * (K / 4) + K / 8]);
    }
    __syncwarp();  // slot s is read: the ring's "empty" side
    if (lane == 0 && i + B_SLOTS < n) {
      fence_proxy_async();
      fill(i + B_SLOTS);
    }
  }
  float4* dst = reinterpret_cast<float4*>(img + (long long)t * 3 * K) + lane;
  float4* one = reinterpret_cast<float4*>(tau + (long long)t * K) + lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 3; ++r) dst[r * (K / 4) + h * (K / 8)] = acc[r][h];
    one[h * (K / 8)] = make_float4(1.f, 1.f, 1.f, 1.f);
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

// packed: [16, ld], ld = q * 256, 16-byte aligned; tiles: [q] int32.
// resident = 0 (B) writes img [n_tiles, 3, 256] and tau [n_tiles, 256], both
// 16-byte aligned; resident = 1 (V) writes out [n_tiles, 3].
extern "C" int egs_tile_sums(const float* packed, long long ld, const int* tiles, int q,
                             int n_tiles, float* img, float* tau, float* out, int resident,
                             void* stream) {
  if (n_tiles <= 0) return 0;
  if (!aligned(packed, 16) || (!resident && (!aligned(img, 16) || !aligned(tau, 16)))) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident) {
    const int blocks = (n_tiles + V_WARPS - 1) / V_WARPS;
    tile_totals_kernel<<<blocks, V_THREADS, 0, s>>>(packed, ld, tiles, q, n_tiles, out);
  } else {
    tile_sums_kernel<<<n_tiles, 32, 0, s>>>(packed, ld, tiles, q, img, tau);
  }
  return (int)cudaGetLastError();
}

// What the compiled B (resident = 0) or V (resident = 1) kernel takes on the
// card, written to out[0..5]: registers a thread, shared bytes a block, local
// (spill) bytes a thread, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads a block and tiles
// (warps) a block.
extern "C" int egs_tile_sums_info(int resident, int* out) {
  const void* kernel = resident ? reinterpret_cast<const void*>(tile_totals_kernel)
                                : reinterpret_cast<const void*>(tile_sums_kernel);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[4] = resident ? V_THREADS : 32;
  out[5] = resident ? V_WARPS : 1;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, out[4], 0);
}
