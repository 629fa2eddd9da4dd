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
// order on 132 SMs, so nothing may carry from one block to the next. A tile's
// chunks are found in the non-decreasing `tiles` by search and summed in a
// fixed order, so a tile that no chunk visits comes out zero (B's TPU output
// is undefined there: it initialises only tiles[0]'s block) and every sum is
// deterministic, with no atomics.
//   A: one block per chunk copies its 16 KB into shared memory with cp.async
//      (async_copy.cuh: volatile PTX, so the loads that nothing reads stay);
//      block 0 writes the zeros.
//   B: the K4 shape, one block per tile and one thread per pixel; two threads
//      find the tile's chunk range by binary search, then every thread adds
//      its pixel of each chunk in index order.
//   V: a warp per tile, 8 tiles a block (272 blocks at the script's 2,170
//      tiles: one wave at 3 blocks an SM). Its time was latency: a block per
//      tile ran 3 waves, each behind a 13-step binary search and scalar
//      loads. Now:
//      * the warp finds both ends of its tile's range together by a 128-ary
//        search: each round a lane reads 4 evenly spaced `tiles` entries
//        for each end and the warp counts those below the tile by
//        __ballot_sync and __popc, so q = 6,266 takes 2 dependent rounds
//        (q up to 16,512 does); the range stays inside [0, q] whatever the
//        values;
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

// B: block t adds rows 0-2 of its chunks into img[t] and writes tau[t].
__global__ void __launch_bounds__(THREADS)
tile_sums_kernel(const float* __restrict__ packed, long long ld,
                 const int* __restrict__ tiles, int q, float* __restrict__ img,
                 float* __restrict__ tau) {
  __shared__ int range[2];
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
  float* dst = img + (long long)t * 3 * K + p;
  dst[0] = a0;
  dst[K] = a1;
  dst[2 * K] = a2;
  tau[(long long)t * K + p] = 1.f;
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
  Search a{0, q, 1}, b{0, q, 1};  // the first chunk of tile t, and of t + 1
  while (a.hi > a.lo || b.hi > b.lo) {
    int va[PROBES], vb[PROBES];
    a.probe(tiles, lane, va);
    b.probe(tiles, lane, vb);
    a.narrow(t, va);
    b.narrow(t + 1, vb);
  }
  const int start = a.lo, end = max(b.lo, a.lo);
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

}  // namespace

// packed: [16, ld] device floats with ld = q * 256; out: out_n floats.
extern "C" int egs_stream_chunks(const float* packed, long long ld, int q, float* out,
                                 int out_n, void* stream) {
  if (q <= 0) return 0;
  stream_chunks_kernel<<<q, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, ld, out, out_n);
  return (int)cudaGetLastError();
}

// packed: [16, ld], ld = q * 256; tiles: [q] int32. resident = 0 (B) writes
// img [n_tiles, 3, 256] and tau [n_tiles, 256]; resident = 1 (V) writes out
// [n_tiles, 3] and needs packed 16-byte aligned.
extern "C" int egs_tile_sums(const float* packed, long long ld, const int* tiles, int q,
                             int n_tiles, float* img, float* tau, float* out, int resident,
                             void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident) {
    if (!aligned(packed, 16)) return (int)cudaErrorMisalignedAddress;
    const int blocks = (n_tiles + V_WARPS - 1) / V_WARPS;
    tile_totals_kernel<<<blocks, V_THREADS, 0, s>>>(packed, ld, tiles, q, n_tiles, out);
  } else {
    tile_sums_kernel<<<n_tiles, THREADS, 0, s>>>(packed, ld, tiles, q, img, tau);
  }
  return (int)cudaGetLastError();
}

// What the compiled V kernel takes on the card, written to out[0..5]:
// registers a thread, shared bytes a block, local (spill) bytes a thread,
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// threads a block and tiles (warps) a block.
extern "C" int egs_tile_totals_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tile_totals_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[4] = V_THREADS;
  out[5] = V_WARPS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], tile_totals_kernel,
                                                            V_THREADS, 0);
}
