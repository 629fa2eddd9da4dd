// K10: chunked row sums at dynamic offsets, staged by TMA bulk copies.
//
// Replaces the Pallas kernel scripts/exp_dma_stream.py `kernel` (:25), a
// proving ground for streaming K-row chunks of an HBM array at runtime
// offsets: out[c] = sum over r < rows[c] of x[offs[c] + r, :], for x [m, 16]
// float32, with each [128, 16] block fetched by a double-buffered DMA one grid
// step ahead. Plain version: probes/exp_dma_stream.py::stream_sums_plain.
//
// What bounds it on an H100: bytes -- the distinct rows of x that the summed
// ranges cover (at most all of x, 16.8 MB at the script's m = 2^18), plus the
// offsets, the row counts and the output. Each chunk is at most 8 KB at a
// data-dependent address, so the pace is set by how many copies are in
// flight, and by the round trips a block waits through one after another.
//
// Design: Hopper's counterpart of the DMA with its semaphores is the Tensor
// Memory Accelerator (tma.cuh). A block of 4 warps takes CHUNKS = 8
// consecutive chunks through a ring of STAGES = 4 slots of 8 KB in shared
// memory, each slot with its own "full" mbarrier; warp w owns slot w
// and the chunks w and w + 4:
//   * the block first reads its chunks' offsets and row counts, clamped into
//     [0, m - 128] and [0, 128], so no value can make it read outside x (the
//     plain version checks them and raises);
//   * a warp's lane 0 fills its slot: a 1-D bulk copy of exactly the rows[c]
//     rows that are summed (rows[c] * 64 bytes) after an arrive that expects
//     that many bytes; a chunk of 0 rows is a plain arrive and no copy;
//   * the warp waits on the slot's barrier with the parity of that use (the
//     k-th use of a slot completes phase k & 1), reads the staged rows as
//     float4 (4 lanes a row, 8 rows a warp step, at most 16 rows a lane in
//     order), adds the 8 lanes of a column quad by 3 xor shuffles, and lanes
//     0-3 store the chunk's 16 sums. No atomics: two calls give the same
//     bits; the rounding depth is at most 15 + 3;
//   * each warp thus runs its slot as a single buffer: it issues its second
//     copy only after it has summed its first, and the ring's depth comes
//     from the 4 warps, not from stages ahead of one reader;
//   * the ring's "empty" side is a __syncwarp: the slot's only readers are
//     its warp's lanes, so past it lane 0 issues fence.proxy.async (their
//     generic-proxy reads before the async proxy's write) and refills the
//     slot with the warp's next chunk. Neither an "empty" mbarrier nor a
//     __syncthreads is needed, and the warps never wait on each other after
//     the prologue. (A block-wide sum of each chunk, with a __syncthreads per
//     chunk as the empty side, took 0.8-1.1 us more a call on the card.)
// At the script's 4,096 chunks that is 512 blocks of ~32 KB, 6 resident an SM:
// one wave on 132 SMs, every block with 4 copies in flight from its start.

#include <cuda_runtime.h>

#include "memory_order.cuh"
#include "tma.cuh"

namespace {

constexpr int K = 128;          // rows of a chunk
constexpr int COLS = 16;        // columns of x
constexpr int THREADS = 128;
constexpr int ROWS_A_STEP = 8;               // rows a warp step reads (4 lanes a row)
constexpr int STAGES = THREADS / 32;         // slots of the ring: one a warp
constexpr int CHUNKS = 8;                    // consecutive chunks per block
// A slot serves at most CHUNKS / STAGES = 2 chunks, so a warp waits on phases
// 0 and 1 of its barrier and the parity never wraps back to 0; the card tests
// (tests/test_torch_cuda.py, K10's cases) cover exactly that. More uses a slot
// would run a wrap that no test runs: add a test that does before raising it.
static_assert(CHUNKS == 2 * STAGES, "the card tests cover two uses of a slot");

__global__ void __launch_bounds__(THREADS)
stream_sums_kernel(const float* __restrict__ x, long long m, const int* __restrict__ offs,
                   const int* __restrict__ rows, int q, float* __restrict__ out) {
  __shared__ __align__(128) float ring[STAGES][K * COLS];
  __shared__ uint64_t full[STAGES];
  __shared__ long long first[CHUNKS];  // clamped first row of each chunk
  __shared__ int count[CHUNKS];        // clamped row count of each chunk
  const int c0 = blockIdx.x * CHUNKS;
  const int n = min(q - c0, CHUNKS);
  const int tid = threadIdx.x;
  if (tid < n) {
    first[tid] = min(max((long long)offs[c0 + tid], 0LL), m - K);
    count[tid] = min(max(rows[c0 + tid], 0), K);
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // chunk i into slot i % STAGES, counted off that slot's barrier
  auto fill = [&](int i) {
    uint64_t* bar = &full[i % STAGES];
    const unsigned bytes = static_cast<unsigned>(count[i]) * COLS * sizeof(float);
    if (bytes == 0) {
      mbar_arrive(bar);
    } else {
      mbar_arrive_expect_tx(bar, bytes);
      bulk_copy_g2s(ring[i % STAGES], x + first[i] * COLS, bytes, bar);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3;                  // columns 4 * quad .. + 3
  const int row0 = lane >> 2;                 // this lane's first row of a chunk
  if (lane == 0 && warp < n) fill(warp);
  for (int i = warp, use = 0; i < n; i += STAGES, ++use) {
    mbar_wait(&full[warp], use & 1);
    const int nr = count[i];
    const float4* b = reinterpret_cast<const float4*>(ring[warp]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K / ROWS_A_STEP; ++k) {
      const int r = row0 + k * ROWS_A_STEP;
      if (r < nr) {
        const float4 v = b[r * (COLS / 4) + quad];
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // the 8 rows of a column quad
      a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
    }
    if (lane < 4) reinterpret_cast<float4*>(out + (long long)(c0 + i) * COLS)[quad] = a;
    __syncwarp();  // slot `warp` is read: the ring's "empty" side
    if (lane == 0 && i + STAGES < n) {
      fence_proxy_async();
      fill(i + STAGES);
    }
  }
}

}  // namespace

// x: [m, 16] device floats, 16-byte aligned, m >= 128; offs, rows: [q] int32;
// out: [q, 16], 16-byte aligned.
extern "C" int egs_stream_sums(const float* x, long long m, const int* offs, const int* rows,
                               int q, float* out, void* stream) {
  if (q <= 0) return 0;
  if (m < K) return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(out, 16)) return (int)cudaErrorMisalignedAddress;
  const int blocks = (q + CHUNKS - 1) / CHUNKS;
  stream_sums_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, m, offs, rows, q, out);
  return (int)cudaGetLastError();
}

// What the compiled K10 kernel takes on the card, written to out[0..6]:
// registers a thread, shared bytes a block, local (spill) bytes a thread,
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// threads a block, ring stages and chunks a block.
extern "C" int egs_stream_sums_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, stream_sums_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[4] = THREADS;
  out[5] = STAGES;
  out[6] = CHUNKS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], stream_sums_kernel,
                                                            THREADS, 0);
}
