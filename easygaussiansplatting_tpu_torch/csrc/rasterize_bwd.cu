// K5: stage-6 backward — one CTA per 16x16 tile, one thread per pixel.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/kernels.py
// `backward_kernel` (reached through ops/pallas/rasterize.py `_bwd_call` and
// `_raster_table_bwd`), non-interleaved path. Plain version:
// ops/rasterize_tiled.py::rasterize_tiled_bwd with ops/blend.py
// ::blend_chunk_bwd.
//
// The TPU kernel streams (chunk x tile) segments in reverse grid order,
// recovers the transmittance in log space with triangular MXU contractions
// and revisits chunk-aligned gradient blocks. None of that carries over. This
// is the shape of the reference's drawB:
//   * one 256-thread block per tile, one thread per pixel, tile-local
//     coordinates (the u gradient is shift-invariant, docs/backward.md B.4);
//   * the tile's list is walked BACK TO FRONT in batches of BATCH entries
//     staged in shared memory, gathered from the K1 table through patch_gsid
//     as K4 stages them; the walk starts at the tile's largest contributor
//     count, so entries no pixel reached are never read (B.2.3);
//   * each pixel starts from its stored final tau, skips entries at
//     positions >= its contrib, re-applies alpha' >= 0.002 through the same
//     inline evaluation as K4 (blend.cuh), recovers the transmittance in
//     front of each entry by division, tau /= (1 - alpha') (B.2.1), and
//     carries g . (colour behind) (B.2.2);
//   * per entry it forms d alpha' (B.1.2, denominator clamped at 1e-6), the
//     clamp and maha > 0 masks (B.3), and nine per-pixel terms: the offset
//     moments dm*dx, dm*dy, dm*dx^2, dm*dx*dy, dm*dy^2 (B.4), dalpha' *
//     alpha' for d alpha, and the colour weights times g (B.5.1);
//   * those reduce over the block's 256 pixels in a fixed order: a warp
//     butterfly, then the eight per-warp partials in shared memory summed
//     by one thread per entry, which writes the patch's nine gradients once.
//     A patch belongs to exactly one tile, so there are no atomics and the
//     result is the same on every run.
// Pixels past W or H (the last tile column of a 979-wide image) have no
// colour gradient and no contributors: they add zeros.
//
// What bounds it on an H100: operations. Each (entry, pixel) pair the walk
// evaluates costs one exp on the MUFU (16 per SM per clock) and 16 FP32
// operations; a live pair (alpha' >= 0.002) two reciprocals and 18 more, and
// up to 8 more for its gradient terms (chip_smoke.py's k5_bound counts them
// on the run's data). The function needs 9 adds per pair to reduce them;
// this kernel spends nine 5-step warp butterflies per warp and entry. The
// gather of table rows is a few MB. Design note for later work: the
// butterflies cost more than the pixel math; a reduction that transposes
// entries onto lanes would cut them.
//
// Output: grads [9, M] float32, rows d ux, uy, conic a, b, c, alpha, r, g,
// b; the caller zero-fills it, and only the slots of entries some pixel of
// their tile reached are written.

#include <cuda_runtime.h>

#include "blend.cuh"

namespace {

using namespace egs_blend;

constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 64;  // entries per staged batch (per-warp partials: BATCH*WARPS*9 floats)
constexpr int TERMS = 9;

__global__ void __launch_bounds__(THREADS)
rasterize_bwd_kernel(const float* __restrict__ table, int ld,
                     const int* __restrict__ patch_gsid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_cnt, int gx, int width, int height,
                     const float* __restrict__ g_image,
                     const float* __restrict__ final_tau,
                     const int* __restrict__ contrib, float* __restrict__ grads,
                     int m) {
  __shared__ float2 s_xy[BATCH];
  __shared__ float4 s_conic[BATCH];
  __shared__ float4 s_rgb[BATCH];
  __shared__ float s_part[BATCH][WARPS][TERMS];
  __shared__ int s_wmax[WARPS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = t % gx, ty = t / gx;
  const int lx = tid % TILE, ly = tid / TILE;
  const int px = tx * TILE + lx, py = ty * TILE + ly;
  const bool inside = px < width && py < height;
  const float ox = (float)(tx * TILE), oy = (float)(ty * TILE);
  const float fx = (float)lx, fy = (float)ly;
  const int start = tile_start[t];

  float tau = 1.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  int cont = 0;
  if (inside) {
    const size_t hw = (size_t)height * width;
    const size_t pix = (size_t)py * width + px;
    tau = final_tau[pix];
    cont = contrib[pix];
    g0 = g_image[pix];
    g1 = g_image[hw + pix];
    g2 = g_image[2 * hw + pix];
  }
  const int wmax = __reduce_max_sync(0xffffffffu, cont);
  if (lane == 0) s_wmax[warp] = wmax;
  __syncthreads();
  int maxc = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) maxc = max(maxc, s_wmax[w]);
  maxc = min(maxc, tile_cnt[t]);  // never read past the tile's list

  float gag = 0.0f;  // g . (blended colour of every entry behind)
  for (int b0 = ((maxc - 1) / BATCH) * BATCH; maxc > 0 && b0 >= 0; b0 -= BATCH) {
    // the previous batch's entries and partials are fully consumed
    __syncthreads();
    const int nb = min(BATCH, maxc - b0);
    if (tid < nb) {
      load_entry(table, ld, patch_gsid[start + b0 + tid], ox, oy, &s_xy[tid],
                 &s_conic[tid], &s_rgb[tid]);
    }
    __syncthreads();
    for (int k = nb - 1; k >= 0; --k) {
      float v[TERMS];
#pragma unroll
      for (int j = 0; j < TERMS; ++j) v[j] = 0.0f;
      bool live = false;
      if (b0 + k < cont) {
        const Alpha a = blend_alpha(s_xy[k], s_conic[k], fx, fy);
        if (a.ap >= ALPHA_SKIP) {
          live = true;
          tau = tau / (1.0f - a.ap);  // transmittance in front of this entry
          const float contr = tau * a.ap;
          const float4 col = s_rgb[k];
          const float cg = col.x * g0 + col.y * g1 + col.z * g2;
          const float dap = tau * cg - gag / fmaxf(1.0f - a.ap, 1e-6f);
          gag += contr * cg;
          if (a.ap < ALPHA_CLAMP) {
            const float dap_ap = dap * a.ap;
            v[5] = dap_ap;
            if (a.maha > 0.0f) {
              const float dm = -0.5f * dap_ap;  // d loss / d maha
              v[0] = dm * a.dx;
              v[1] = dm * a.dy;
              v[2] = dm * a.dx * a.dx;
              v[3] = dm * a.dx * a.dy;
              v[4] = dm * a.dy * a.dy;
            }
          }
          v[6] = contr * g0;
          v[7] = contr * g1;
          v[8] = contr * g2;
        }
      }
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int j = 0; j < TERMS; ++j)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < TERMS; ++j) s_part[k][warp][j] = v[j];
      }
    }
    __syncthreads();
    if (tid < nb) {
      float sum[TERMS];
#pragma unroll
      for (int j = 0; j < TERMS; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += s_part[tid][w][j];
        sum[j] = acc;
      }
      const float4 q = s_conic[tid];  // a b c alpha
      const size_t slot = (size_t)start + b0 + tid;
      grads[slot] = 2.0f * q.x * sum[0] + 2.0f * q.y * sum[1];
      grads[(size_t)m + slot] = 2.0f * q.z * sum[1] + 2.0f * q.y * sum[0];
      grads[2 * (size_t)m + slot] = sum[2];
      grads[3 * (size_t)m + slot] = 2.0f * sum[3];
      grads[4 * (size_t)m + slot] = sum[4];
      grads[5 * (size_t)m + slot] = sum[5] / fmaxf(q.w, 1e-12f);
      grads[6 * (size_t)m + slot] = sum[6];
      grads[7 * (size_t)m + slot] = sum[7];
      grads[8 * (size_t)m + slot] = sum[8];
    }
  }
}

}  // namespace

// table: [N, ld] float32 device, 16-byte aligned, ld % 4 == 0; patch_gsid
// [M], tile_start [T], tile_cnt [T] int32 with T = gx * gy; g_image [3,H,W],
// final_tau [H,W] float32 and contrib [H,W] int32 from the forward; grads
// [9, M] float32 device output, zero-filled by the caller.
extern "C" int egs_rasterize_bwd(const float* table, int ld, const int* patch_gsid,
                                 const int* tile_start, const int* tile_cnt, int gx,
                                 int gy, int width, int height, const float* g_image,
                                 const float* final_tau, const int* contrib,
                                 float* grads, int m, void* stream) {
  if (ld % 4 != 0 || ld < 9) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = gx * gy;
  if (n_tiles <= 0) return 0;
  rasterize_bwd_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ld, patch_gsid, tile_start, tile_cnt, gx, width, height, g_image, final_tau,
      contrib, grads, m);
  return static_cast<int>(cudaGetLastError());
}
