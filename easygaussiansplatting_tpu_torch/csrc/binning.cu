// K12: tile binning whose work follows the view: the per-tile draw lists of
// ops/binning.py::bin_gaussians built from the depth-sorted gaussians and
// the patches they cover, never from the slot budget.
//
// Replaces no Pallas kernel: the JAX package bins with plain XLA ops
// (easygaussiansplatting_tpu/ops/binning.py `bin_gaussians`), which XLA
// fuses; run eagerly on the card, the same ops (the slot path of
// ops/binning.py) expand into arrays of `max_patches` slots with scatters,
// gathers and a sort over all of them, whatever the view needs. Plain
// version: that slot path (`use_kernels=False`), which every output here
// equals bit for bit.
//
// What bounds it on an H100: bytes, ~0.3 GB a truck-sized view (the
// gaussians' table read, the patches written once depth-major, read twice
// and written once more in tile order, the padding filled), ~0.1 ms at 3.35
// TB/s; and, around it, the host's launches: the slot path's N-long
// preparation alone was some 45 PyTorch operations. The chain, with the
// depth sort (torch.sort) and K3 (scan.cu) between its launches:
//   (0) bin_prep_kernel, a thread a gaussian in id order: its depth key
//       (the bits of its depth, +inf where invalid or below ALPHA_SKIP),
//       its tile rect and validity (`gaussian_rects`) and its skip-ellipse
//       radius^2 (`skip_radius2`), in one pass over coalesced rows.
//   (1) bin_count_kernel, a thread a depth-sorted gaussian: its covered
//       tile rows and, over them, the patches left by the per-row ellipse
//       x-extent (unbudgeted), as two rows of an [2, N] int32 array.
//   (2) K3 on those two rows: each gaussian's first row and first patch.
//   (3) bin_emit_kernel, a thread a gaussian: the row budget (a gaussian
//       that straddles max_rows recomputes the patches of its kept rows;
//       the one that covers row max_rows - 1 writes `total`), then its
//       patches depth-major (gaussian, row, x) into the slots below
//       max_patches, as the slot path orders them, and its kept count by
//       gaussian id. A gaussian after the row budget has no patches, so
//       the unbudgeted first-patch positions are exact wherever used.
//   (4) bin_hist_kernel, a warp a chunk of the plan's 2,048 or more
//       consecutive slots below `kept` (the chunk doubles while the count
//       matrix would pass MAX_CELLS) and a band of at most BAND_MAX tiles
//       (a block's row of the grid): the chunk's counts of the band's tiles
//       in shared memory (a match_any leader adds its peers' count, never a
//       global atomic), written to a tile-major [n_tiles, n_chunks] matrix.
//       A view of more tiles than a band holds runs in more bands, each
//       reading the whole chunk, so any tile count fits in shared memory.
//   (5) K3 on that matrix as one row: the inclusive prefix of (tile,
//       chunk), so each chunk's start in each tile's list, tile_start and
//       tile_cnt come out of one scan.
//   (6) bin_place_kernel, a warp a chunk and a band again: each slot of
//       the band's tiles goes to its tile's next position, ranked in slot
//       order within a round by match_any, so the lists stay in depth order
//       (a stable counting sort by tile); the first band's warp fills its
//       chunk's slots past `kept` with the padding (gsid -1, tile n_tiles).
// The plan (egs_bin_plan) is asked for once a call and passed to (3)+(4)
// and (6), which check it.
// Nothing reads the host: `total` and `kept` stay on the device.
//
// Numerics: the rects, the radius and the row extent repeat the slot
// path's float32 expressions in its order of operations (each a PyTorch
// kernel, rounded on its own). This file is compiled with -fmad=false
// (ops/kernels/_build.py) and uses IEEE division, sqrtf and logf (the
// libdevice function PyTorch's float log calls), so nothing contracts or
// approximates: one ulp there can move a tile list. clamp, minimum and
// maximum propagate NaN as PyTorch's do. The float literals (1e-12f,
// 0.002f, 1.00001f, 1e-4f) are the float32 roundings of the slot path's
// double constants, checked to round alike.

#include <cuda_runtime.h>
#include <stdint.h>

#include "memory_order.cuh"

namespace {

constexpr int THREADS = 256;           // prep, count and emit: a thread a gaussian
constexpr int TILE_PX = 16;            // pixels a tile edge (ops/binning.py TILE)
constexpr int MIN_CHUNK = 2048;        // slots a warp in hist and place
constexpr long long MAX_CELLS = 1LL << 22;  // n_tiles * n_chunks, before the chunk doubles
constexpr int WARPS = 4;               // warps (chunks) a block of hist and place
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block can opt in to
constexpr int BAND_MAX = SMEM_MAX / (4 * WARPS);  // tiles a band: a warp's int counters
constexpr int UNROLL = 8;              // rounds of a warp whose loads go out together
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_SKIP = 0.002f;   // ops/binning.py ALPHA_SKIP
constexpr int INF_BITS = 0x7f800000;   // +inf as int32 bits: the key of an invalid gaussian

struct Plan {
  int chunk;       // slots a warp
  int n_chunks;
  int band;        // tiles a band
  int n_bands;     // the grid's rows
};

Plan make_plan(int n_tiles, long long max_patches) {
  Plan p;
  long long chunk = MIN_CHUNK;
  while ((long long)n_tiles * ((max_patches + chunk - 1) / chunk) > MAX_CELLS &&
         chunk < (1LL << 24))
    chunk *= 2;
  p.chunk = (int)chunk;
  p.n_chunks = (int)((max_patches + chunk - 1) / chunk);
  p.band = n_tiles < BAND_MAX ? n_tiles : BAND_MAX;
  p.n_bands = (n_tiles + p.band - 1) / p.band;
  return p;
}

// a budget K12 takes: int32 slot positions, as the slot path's
bool plan_ok(int n_tiles, long long max_patches) {
  return n_tiles >= 1 && max_patches >= 1 && max_patches <= 0x7fffffffLL;
}

// a plan passed back in that covers the budget and the tiles, and whose
// counters fit a block's shared memory
bool plan_covers(const Plan& p, int n_tiles, long long max_patches) {
  return plan_ok(n_tiles, max_patches) && p.chunk >= 32 && p.n_chunks >= 1 &&
         (long long)p.chunk * p.n_chunks >= max_patches && p.band >= 1 &&
         p.band <= BAND_MAX && p.n_bands >= 1 && p.n_bands <= 65535 &&
         (long long)p.band * p.n_bands >= n_tiles;
}

// PyTorch's float clamp, minimum and maximum: NaN in, NaN out
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// A gaussian's row-extent inputs: mean, conic, skip-ellipse radius^2 and
// its AABB's tile x-range as floats (the slot path's `gtab` row).
struct Row {
  float ux, uy, ca, cb, cc, r2, fx0, fx1;
};

// conic == nullptr: no conics, (1, 0, 1) as the slot path fills them
__device__ __forceinline__ Row load_row(long long g, const float* us, long long us_stride,
                                        const float* conic, long long conic_stride,
                                        const float* r2, int4 rect) {
  Row r;
  r.ux = us[g * us_stride];
  r.uy = us[g * us_stride + 1];
  r.ca = conic != nullptr ? conic[g * conic_stride] : 1.0f;
  r.cb = conic != nullptr ? conic[g * conic_stride + 1] : 0.0f;
  r.cc = conic != nullptr ? conic[g * conic_stride + 2] : 1.0f;
  r.r2 = r2[g];
  r.fx0 = (float)rect.x;
  r.fx1 = (float)rect.z;
  return r;
}

// Tile row ty of a gaussian: its first tile x and its width in tiles, as
// the slot path's per-row ellipse x-extent gives them (ops/binning.py).
__device__ __forceinline__ int row_extent(const Row& g, int ty, int* rx0) {
  const float ftile = (float)TILE_PX;
  float dy0 = (float)ty * ftile - g.uy;
  float dy1 = dy0 + (ftile - 1.0f);
  float det = clamp_min(g.ca * g.cc - g.cb * g.cb, 1e-12f);
  float ca_safe = clamp_min(g.ca, 1e-12f);
  float dy_min2 = dy0 * dy1 > 0.0f ? minimum(dy0 * dy0, dy1 * dy1) : 0.0f;
  float disc = g.ca * g.r2 - det * dy_min2;
  float sr = sqrtf(clamp_min(disc, 0.0f)) / ca_safe;
  float xc0 = -g.cb * dy0 / ca_safe;
  float xc1 = -g.cb * dy1 / ca_safe;
  float x_lo = g.ux + minimum(xc0, xc1) - sr - 0.5f;
  float x_hi = g.ux + maximum(xc0, xc1) + sr + 0.5f;
  float ex0 = clamp(floorf(x_lo / ftile), g.fx0, g.fx1);
  float ex1 = clamp(floorf(x_hi / ftile) + 1.0f, ex0, g.fx1);
  *rx0 = (int)ex0;
  return disc >= 0.0f ? (int)(ex1 - ex0) : 0;
}

// One tile edge of `gaussian_rects`: clamp(rnd(v / 16), 0, hi) as int32
__device__ __forceinline__ int edge(float v, bool up, int hi) {
  const float q = v / (float)TILE_PX;
  return (int)clamp(up ? ceilf(q) : floorf(q), 0.0f, (float)hi);
}

// (0) depth keys, rects, validity and skip radii, by gaussian id. alphas ==
// nullptr: no alpha test; conic false: no conics, so r2 = +inf.
__global__ void __launch_bounds__(THREADS)
bin_prep_kernel(const float* __restrict__ us, long long us_stride,
                const float* __restrict__ areas, long long areas_stride,
                const float* __restrict__ depths, long long depths_stride,
                const unsigned char* __restrict__ valid_in, const float* __restrict__ alphas,
                long long alphas_stride, bool conic, int n, int gx, int gy,
                int* __restrict__ keys, int4* __restrict__ rects,
                unsigned char* __restrict__ valid, float* __restrict__ r2) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n) return;
  bool v = valid_in[g] != 0;
  const float alpha = alphas != nullptr ? alphas[g * alphas_stride] : 0.0f;
  if (alphas != nullptr) v = v && alpha >= ALPHA_SKIP;
  keys[g] = v ? __float_as_int(depths[g * depths_stride]) : INF_BITS;
  const float ux = us[g * us_stride], uy = us[g * us_stride + 1];
  const float ax = areas[g * areas_stride], ay = areas[g * areas_stride + 1];
  int4 r;
  r.x = edge(ux - ax, false, gx);
  r.y = edge(uy - ay, false, gy);
  r.z = edge(ux + ax, true, gx);
  r.w = edge(uy + ay, true, gy);
  rects[g] = r;
  valid[g] = v && (r.z - r.x) * (r.w - r.y) > 0;
  float rad = __int_as_float(INF_BITS);
  if (conic) {  // skip_radius2: 2 log(alpha / ALPHA_SKIP) (1 + 1e-5) + 1e-4, clamped
    rad = 2.0f * logf(clamp_min(alpha, 1e-12f) / ALPHA_SKIP);
    rad = rad * 1.00001f;
    rad = clamp_min(rad + 1e-4f, 0.0f);
  }
  r2[g] = rad;
}

// (1) rows and unbudgeted patches of each depth-sorted gaussian
__global__ void __launch_bounds__(THREADS)
bin_count_kernel(const long long* __restrict__ order, const int4* __restrict__ rects,
                 const unsigned char* __restrict__ valid, const float* __restrict__ us,
                 long long us_stride, const float* __restrict__ conic, long long conic_stride,
                 const float* __restrict__ r2, int n, int* __restrict__ counts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long g = order[i];
  int rows = 0, patches = 0;
  if (valid[g]) {
    const int4 rect = rects[g];
    const Row row = load_row(g, us, us_stride, conic, conic_stride, r2, rect);
    rows = rect.w - rect.y;
    for (int ty = rect.y; ty < rect.w; ++ty) {
      int rx0;
      patches += row_extent(row, ty, &rx0);
    }
  }
  counts[i] = rows;
  counts[n + i] = patches;
}

// The scalars: total, n_dropped, total_rows, rows_dropped, kept
enum { S_TOTAL, S_DROPPED, S_ROWS, S_ROWS_DROPPED, S_KEPT, N_SCALARS };

// (3) the row budget, the totals, each gaussian's patches depth-major and
// its kept count by gaussian id
__global__ void __launch_bounds__(THREADS)
bin_emit_kernel(const long long* __restrict__ order, const int4* __restrict__ rects,
                const float* __restrict__ us, long long us_stride,
                const float* __restrict__ conic, long long conic_stride,
                const float* __restrict__ r2, int n, int gx, const int* __restrict__ counts,
                const int* __restrict__ cums, int max_rows, int max_patches,
                int* __restrict__ scalars, int* __restrict__ dm_tile, int* __restrict__ dm_gsid,
                int* __restrict__ gsid_counts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long g = order[i];
  const int rows = counts[i];
  const int full = counts[n + i];
  const int rstart = cums[i] - rows;
  const int pstart = cums[n + i] - full;
  const int total_rows = cums[n - 1];
  const int mrows = min(total_rows, max_rows);
  const int kept_rows = max(0, min(mrows - rstart, rows));
  int patches = full;
  Row row;
  int4 rect;
  if (kept_rows > 0) {
    rect = rects[g];
    row = load_row(g, us, us_stride, conic, conic_stride, r2, rect);
  }
  if (kept_rows < rows) {  // straddles the row budget, or lies past it
    patches = 0;
    for (int j = 0; j < kept_rows; ++j) {
      int rx0;
      patches += row_extent(row, rect.y + j, &rx0);
    }
  }
  // `total` counts the patches of the rows the row budget keeps: the last
  // gaussian's end when every row is kept, else the end of the gaussian
  // that covers row max_rows - 1
  bool writes_total;
  int total = 0;
  if (total_rows <= max_rows) {
    writes_total = i == n - 1;
    total = cums[2 * n - 1];
  } else if (max_rows == 0) {
    writes_total = i == 0;
  } else {
    writes_total = rstart <= max_rows - 1 && max_rows - 1 < rstart + rows;
    total = pstart + patches;
  }
  if (writes_total) {
    const int kept = min(total, max_patches);
    scalars[S_TOTAL] = total;
    scalars[S_DROPPED] = total - kept;
    scalars[S_KEPT] = kept;
  }
  if (i == 0) {
    scalars[S_ROWS] = total_rows;
    scalars[S_ROWS_DROPPED] = total_rows - mrows;
  }
  // positions are exact wherever patches > 0 (every earlier gaussian's rows
  // are all kept)
  const int end = patches > 0 ? min(pstart + patches, max_patches) : 0;
  const int first = patches > 0 ? min(pstart, max_patches) : 0;
  if (gsid_counts != nullptr) gsid_counts[g] = end - first;
  int s = pstart;
  for (int j = 0; j < kept_rows && s < end; ++j) {
    int rx0;
    const int w = row_extent(row, rect.y + j, &rx0);
    const int base = (rect.y + j) * gx + rx0;
    for (int k = 0; k < w && s < end; ++k, ++s) {
      dm_tile[s] = base + k;
      dm_gsid[s] = (int)g;
    }
  }
}

// The band tile of a slot's tile id, or -1 outside the band [t0, t0 + nb)
__device__ __forceinline__ int in_band(int tile, int t0, int nb) {
  const int t = tile - t0;
  return (unsigned)t < (unsigned)nb ? t : -1;
}

// (4) per-tile counts of each chunk of slots below `kept`, for the tiles of
// the block's band
__global__ void bin_hist_kernel(const int* __restrict__ dm_tile, const int* __restrict__ scalars,
                                int chunk, int n_chunks, int n_tiles, int band,
                                int* __restrict__ hist) {
  extern __shared__ int s_cnt[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= n_chunks) return;
  const int t0 = blockIdx.y * band;
  const int nb = min(band, n_tiles - t0);
  int* cnt = s_cnt + warp * band;
  for (int t = lane; t < nb; t += 32) cnt[t] = 0;
  __syncwarp();
  const long long base = (long long)c * chunk;
  const long long end = min(base + chunk, (long long)scalars[S_KEPT]);
  for (long long r0 = base; r0 < end; r0 += 32 * UNROLL) {
    int t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long idx = r0 + u * 32 + lane;
      t[u] = idx < end ? in_band(dm_tile[idx], t0, nb) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned peers = __match_any_sync(FULL, t[u]);
      if (t[u] >= 0 && lane == __ffs(peers) - 1) cnt[t[u]] += __popc(peers);
      __syncwarp();
    }
  }
  for (int t = lane; t < nb; t += 32) hist[(long long)(t0 + t) * n_chunks + c] = cnt[t];
}

// (6) each slot of the band's tiles to its tile's next position; in the
// first band, the padding and the tile ranges
__global__ void bin_place_kernel(const int* __restrict__ dm_tile, const int* __restrict__ dm_gsid,
                                 const int* __restrict__ hist, const int* __restrict__ sums,
                                 const int* __restrict__ scalars, int chunk, int n_chunks,
                                 int n_tiles, int band, int max_patches,
                                 int* __restrict__ out_gsid, int* __restrict__ out_tile,
                                 int* __restrict__ tile_start, int* __restrict__ tile_cnt) {
  extern __shared__ int s_off[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= n_chunks) return;
  const bool first_band = blockIdx.y == 0;
  const int t0 = blockIdx.y * band;
  const int nb = min(band, n_tiles - t0);
  // the tile ranges, spread over the first band's warps: tile t's
  // inclusive sum ends its last chunk's cell
  for (long long t = (long long)c * 32 + lane; first_band && t < n_tiles;
       t += 32LL * n_chunks) {
    const long long first = t * n_chunks;
    const int start = sums[first] - hist[first];
    tile_start[t] = start;
    tile_cnt[t] = sums[first + n_chunks - 1] - start;
  }
  int* off = s_off + warp * band;
  for (int t = lane; t < nb; t += 32) {
    const long long cell = (long long)(t0 + t) * n_chunks + c;
    off[t] = sums[cell] - hist[cell];
  }
  __syncwarp();
  const int kept = scalars[S_KEPT];
  const long long base = (long long)c * chunk;
  const long long stop = min(base + chunk, (long long)max_patches);
  const long long end = min(stop, (long long)kept);
  const unsigned lower = (1u << lane) - 1u;
  for (long long r0 = base; r0 < end; r0 += 32 * UNROLL) {
    int t[UNROLL], g[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long idx = r0 + u * 32 + lane;
      t[u] = idx < end ? in_band(dm_tile[idx], t0, nb) : -1;
      g[u] = t[u] >= 0 ? dm_gsid[idx] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned peers = __match_any_sync(FULL, t[u]);
      int pos = 0;
      if (t[u] >= 0) pos = off[t[u]] + __popc(peers & lower);
      __syncwarp();
      if (t[u] >= 0) {
        out_gsid[pos] = g[u];
        out_tile[pos] = t0 + t[u];
        if (lane == __ffs(peers) - 1) off[t[u]] += __popc(peers);
      }
      __syncwarp();
    }
  }
  for (long long idx = (end > base ? end : base) + lane; first_band && idx < stop; idx += 32) {
    out_gsid[idx] = -1;
    out_tile[idx] = n_tiles;
  }
}

// a chunk of a band a warp: a grid of chunk groups by bands
cudaError_t launch_tiled(const void* fn, const Plan& p, void** args, cudaStream_t s) {
  const int smem = WARPS * p.band * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((p.n_chunks + WARPS - 1) / WARPS), (unsigned)p.n_bands);
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(32 * WARPS), args, smem, s);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace

// K12's plan for a view of n_tiles tiles at a budget of max_patches slots:
// slots a chunk, chunks, tiles a band and bands of the hist and place
// kernels, warps a block, dynamic shared bytes a block, and the cells of
// the [n_tiles, n_chunks] count matrix, to seven int64s.
// cudaErrorInvalidValue where K12 cannot take the budget (below 1 or past
// int32 positions) or there is no tile.
extern "C" int egs_bin_plan(int n_tiles, long long max_patches, long long* out) {
  if (!plan_ok(n_tiles, max_patches)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n_tiles, max_patches);
  out[0] = p.chunk;
  out[1] = p.n_chunks;
  out[2] = p.band;
  out[3] = p.n_bands;
  out[4] = WARPS;
  out[5] = 4LL * WARPS * p.band;
  out[6] = (long long)n_tiles * p.n_chunks;
  return 0;
}

// (0): keys [n] int32, rects [n, 4] int32, valid [n] bool and r2 [n]
// float32 by gaussian id; alphas nullable (no alpha test), conic 0 or 1
extern "C" int egs_bin_prep(const float* us, long long us_stride, const float* areas,
                            long long areas_stride, const float* depths, long long depths_stride,
                            const unsigned char* valid_in, const float* alphas,
                            long long alphas_stride, int conic, int n, int gx, int gy, int* keys,
                            int* rects, unsigned char* valid, float* r2, void* stream) {
  if (n < 1 || !aligned(rects, 16)) return (int)cudaErrorInvalidValue;
  bin_prep_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      us, us_stride, areas, areas_stride, depths, depths_stride, valid_in, alphas, alphas_stride,
      conic != 0, n, gx, gy, keys, reinterpret_cast<int4*>(rects), valid, r2);
  return (int)cudaGetLastError();
}

// (1): counts [2, n] int32 (rows, unbudgeted patches) by depth rank; order
// [n] int64 (torch.sort's indices); conic nullable
extern "C" int egs_bin_count(const long long* order, const int* rects, const unsigned char* valid,
                             const float* us, long long us_stride, const float* conic,
                             long long conic_stride, const float* r2, int n, int* counts,
                             void* stream) {
  if (n < 1 || !aligned(rects, 16)) return (int)cudaErrorInvalidValue;
  bin_count_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      order, reinterpret_cast<const int4*>(rects), valid, us, us_stride, conic, conic_stride, r2,
      n, counts);
  return (int)cudaGetLastError();
}

// (3) and (4): from the counts and their K3 inclusive sums `cums` [2, n],
// the scalars [5], the depth-major slots, gsid_counts [n] (nullable) and the
// [n_tiles, n_chunks] count matrix, under egs_bin_plan's chunk, chunks,
// band and bands
extern "C" int egs_bin_emit(const long long* order, const int* rects, const float* us,
                            long long us_stride, const float* conic, long long conic_stride,
                            const float* r2, int n, int gx, int n_tiles, const int* counts,
                            const int* cums, int max_rows, long long max_patches, int* scalars,
                            int* dm_tile, int* dm_gsid, int* gsid_counts, int* hist, int chunk,
                            int n_chunks, int band, int n_bands, void* stream) {
  const Plan p{chunk, n_chunks, band, n_bands};
  if (n < 1 || max_rows < 0 || !aligned(rects, 16) || !plan_covers(p, n_tiles, max_patches))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mp = (int)max_patches;
  bin_emit_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      order, reinterpret_cast<const int4*>(rects), us, us_stride, conic, conic_stride, r2, n, gx,
      counts, cums, max_rows, mp, scalars, dm_tile, dm_gsid, gsid_counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int* cdm = dm_tile;
  const int* cscal = scalars;
  void* args[] = {(void*)&cdm, (void*)&cscal, (void*)&chunk, (void*)&n_chunks, (void*)&n_tiles,
                  (void*)&band, (void*)&hist};
  return (int)launch_tiled((const void*)bin_hist_kernel, p, args, s);
}

// (6): from the count matrix and its K3 inclusive sum, the draw lists
// [max_patches] and the tile ranges [n_tiles], under the plan of (3)+(4)
extern "C" int egs_bin_place(const int* dm_tile, const int* dm_gsid, const int* hist,
                             const int* sums, const int* scalars, int n_tiles,
                             long long max_patches, int* out_gsid, int* out_tile,
                             int* tile_start, int* tile_cnt, int chunk, int n_chunks, int band,
                             int n_bands, void* stream) {
  const Plan p{chunk, n_chunks, band, n_bands};
  if (!plan_covers(p, n_tiles, max_patches)) return (int)cudaErrorInvalidValue;
  int mp = (int)max_patches;
  void* args[] = {(void*)&dm_tile, (void*)&dm_gsid, (void*)&hist, (void*)&sums,
                  (void*)&scalars, (void*)&chunk, (void*)&n_chunks, (void*)&n_tiles,
                  (void*)&band, (void*)&mp, (void*)&out_gsid, (void*)&out_tile,
                  (void*)&tile_start, (void*)&tile_cnt};
  return (int)launch_tiled((const void*)bin_place_kernel, p, args,
                           static_cast<cudaStream_t>(stream));
}
