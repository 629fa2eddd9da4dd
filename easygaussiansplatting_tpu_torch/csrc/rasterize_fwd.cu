// K4: stage-6 forward blend — one CTA per 16x16 tile, one thread per pixel.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/kernels.py
// `forward_kernel` (reached through ops/pallas/rasterize.py `_fwd_call` and
// `rasterize_pallas`). Plain version: ops/rasterize_tiled.py with
// ops/blend.py.
//
// The TPU kernel streams a packed [M,16] patch array through a (chunk x tile)
// segment grid, turns the per-pixel recurrence into sublane prefix products
// and an MXU contraction, and skips saturated tiles with an SMEM flag. None of
// that is needed here. This is the reference's own draw kernel shape:
//   * one 256-thread block per tile, one thread per pixel, in tile-local
//     coordinates (pixel (0..15, 0..15), means shifted by the tile origin);
//   * the tile's [tile_start, tile_start + tile_cnt) list is staged in shared
//     memory in batches of 256 entries, each thread gathering one table row
//     through patch_gsid — no packed per-patch array exists in memory;
//   * each pixel walks the batch front to back sequentially and stops once
//     its transmittance falls below 1e-4;
//   * the block leaves early, via __syncthreads_count, once every pixel is
//     done;
//   * the outputs go straight to image [3,H,W], final_tau [H,W] and contrib
//     [H,W], with no write for pixels past W or H; empty tiles write colour
//     0, tau 1, contrib 0.
//
// What bounds it on an H100: operations. Each (entry, pixel) pair evaluated
// costs one exp and ~15 FP32 operations, so the MUFU exp rate (16 per SM per
// clock) and the FP32 rate bound it; the gather of table rows is a few tens
// of MB. Early exit per pixel and per block keeps the evaluated pairs near
// what the data needs.
//
// The alpha' evaluation and the row staging live in blend.cuh, shared with
// the backward (rasterize_bwd.cu), which must replay these decisions exactly.
//
// Contract (ops/rasterize_ref.py, kernels.py): alpha' = min(0.99, alpha *
// exp(-0.5 * max(0, maha))); skip alpha' < 0.002; an entry contributes iff
// the tau before it is >= 1e-4; contrib is the 1-based position in the tile's
// list of the last contributing entry and final_tau the tau after it.
// Gaussian ids of -1 contribute nothing.

#include <cuda_runtime.h>

#include "blend.cuh"

namespace {

using namespace egs_blend;

// table rows: ux uy ca cb | cc alpha r g | b ... (ld floats per row, ld % 4 == 0)
__global__ void __launch_bounds__(THREADS)
rasterize_fwd_kernel(const float* __restrict__ table, int ld,
                     const int* __restrict__ patch_gsid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_cnt, int gx, int width,
                     int height, float* __restrict__ image,
                     float* __restrict__ final_tau, int* __restrict__ contrib) {
  __shared__ float2 s_xy[THREADS];     // tile-local mean
  __shared__ float4 s_conic[THREADS];  // conic a b c, alpha
  __shared__ float4 s_rgb[THREADS];    // rgb, unused

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = t % gx, ty = t / gx;
  const int lx = tid % TILE, ly = tid / TILE;
  const int px = tx * TILE + lx, py = ty * TILE + ly;
  const bool inside = px < width && py < height;
  const float ox = (float)(tx * TILE), oy = (float)(ty * TILE);
  const float fx = (float)lx, fy = (float)ly;
  const int start = tile_start[t];
  const int cnt = tile_cnt[t];

  float tau = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int cont = 0;
  bool done = !inside;

  for (int b0 = 0; b0 < cnt; b0 += THREADS) {
    // every pixel done -> the whole block leaves (also the barrier that
    // keeps the previous batch's shared rows alive until all have read them)
    if (__syncthreads_count(done) == THREADS) break;
    const int j = b0 + tid;
    if (j < cnt) {
      load_entry(table, ld, patch_gsid[start + j], ox, oy, &s_xy[tid], &s_conic[tid],
                 &s_rgb[tid]);
    }
    __syncthreads();
    const int nb = min(THREADS, cnt - b0);
    for (int k = 0; k < nb && !done; ++k) {
      const float ap = blend_alpha(s_xy[k], s_conic[k], fx, fy).ap;
      if (ap < ALPHA_SKIP) continue;
      const float w = tau * ap;
      const float4 col = s_rgb[k];
      c0 += w * col.x;
      c1 += w * col.y;
      c2 += w * col.z;
      cont = b0 + k + 1;
      tau = tau * (1.0f - ap);
      done = tau < TAU_STOP;  // no later entry can contribute
    }
  }

  if (inside) {
    const size_t hw = (size_t)height * width;
    const size_t pix = (size_t)py * width + px;
    image[pix] = c0;
    image[hw + pix] = c1;
    image[2 * hw + pix] = c2;
    final_tau[pix] = tau;
    contrib[pix] = cont;
  }
}

}  // namespace

// table: [N, ld] float32 device, 16-byte aligned, ld % 4 == 0; patch_gsid
// [M], tile_start [T], tile_cnt [T] int32 with T = gx * gy; image [3,H,W],
// final_tau [H,W] float32, contrib [H,W] int32 device outputs.
extern "C" int egs_rasterize_fwd(const float* table, int ld,
                                 const int* patch_gsid, const int* tile_start,
                                 const int* tile_cnt, int gx, int gy, int width,
                                 int height, float* image, float* final_tau,
                                 int* contrib, void* stream) {
  if (ld % 4 != 0 || ld < 9) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = gx * gy;
  if (n_tiles <= 0) return 0;
  rasterize_fwd_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ld, patch_gsid, tile_start, tile_cnt, gx, width, height, image,
      final_tau, contrib);
  return static_cast<int>(cudaGetLastError());
}
