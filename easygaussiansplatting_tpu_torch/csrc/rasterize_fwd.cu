// K4: stage-6 forward blend — one 64-thread CTA per 16x16 tile, a 2x2 pixel
// quad per thread.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/kernels.py
// `forward_kernel` (reached through ops/pallas/rasterize.py `_fwd_call` and
// `rasterize_pallas`). Plain version: ops/rasterize_tiled.py with
// ops/blend.py.
//
// The TPU kernel streams a packed [M,16] patch array through a (chunk x tile)
// segment grid, turns the per-pixel recurrence into sublane prefix products
// and an MXU contraction, and skips saturated tiles with an SMEM flag. None of
// that is needed here. The shape:
//   * one 64-thread block per tile; thread t blends the 2x2 pixel quad
//     (t % 8, t / 8) in tile-local coordinates (means shifted by the tile
//     origin), four independent transmittance chains a thread;
//   * the tile's [tile_start, tile_start + tile_cnt) list is staged in shared
//     memory in batches of BATCH entries, each gathered from the K1 table
//     through patch_gsid with its conic pre-scaled (blend.cuh) — no packed
//     per-patch array exists in memory;
//   * each thread walks the batch front to back, reading an entry from
//     shared memory once for its four pixels and evaluating the four pairs
//     without a branch (selects, not jumps, so the four chains interleave);
//     a pixel is done once its transmittance falls below 1e-4, a thread
//     once all four are;
//   * the block leaves early, via __syncthreads_count, once every pixel is
//     done;
//   * the outputs go straight to image [3,H,W], final_tau [H,W] and contrib
//     [H,W], with no write for pixels past W or H; empty tiles write colour
//     0, tau 1, contrib 0.
//
// What bounds it on an H100: instruction issue and latency. Each (entry,
// pixel) pair costs the exponent (5 FP32 operations, the offsets shared by
// the quad), one ex2 on the MUFU and ~12 more operations and selects. A
// pixel a thread (256 threads, branches) takes ~40 instructions a
// warp-iteration; here the entry's shared loads and loop
// control serve four pixels, the conic comes pre-scaled for ex2.approx in
// place of the accurate expf, and the branch-free body lets a warp issue its
// four chains back to back. (A per-warp skip of entries past blend.cuh's
// cutoff, as K5 has, measured slower here: its votes cost more than the
// exponentials they save.) The gather of table rows is a few tens of MB.
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

constexpr int BATCH = 128;  // entries per staged batch

__device__ __forceinline__ float max_tau(const float (&tau)[PIX]) {
  float m = tau[0];
#pragma unroll
  for (int i = 1; i < PIX; ++i) m = fmaxf(m, tau[i]);
  return m;
}

// table rows: ux uy ca cb | cc alpha r g | b ... (ld floats per row, ld % 4 == 0)
__global__ void __launch_bounds__(NT)
rasterize_fwd_kernel(const float* __restrict__ table, int ld,
                     const int* __restrict__ patch_gsid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_cnt, int gx, int width,
                     int height, float* __restrict__ image,
                     float* __restrict__ final_tau, int* __restrict__ contrib) {
  __shared__ float4 s_p[BATCH];
  __shared__ float4 s_q[BATCH];
  __shared__ float2 s_gb[BATCH];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = t % gx, ty = t / gx;
  const int lx = QX * (tid % COLS), ly = QY * (tid / COLS);
  const float ox = (float)(tx * TILE), oy = (float)(ty * TILE);
  const int start = tile_start[t];
  const int cnt = tile_cnt[t];

  // A pixel is done once tau < TAU_STOP; pixels past W or H start done
  // (tau 0) and are never written.
  float tau[PIX], c0[PIX], c1[PIX], c2[PIX];
  int cont[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int px = tx * TILE + lx + i % QX, py = ty * TILE + ly + i / QX;
    tau[i] = px < width && py < height ? 1.0f : 0.0f;
    c0[i] = c1[i] = c2[i] = 0.0f;
    cont[i] = 0;
  }

  for (int b0 = 0; b0 < cnt; b0 += BATCH) {
    // every pixel done -> the whole block leaves (also the barrier that
    // keeps the previous batch's shared rows alive until all have read them)
    if (__syncthreads_count(max_tau(tau) < TAU_STOP) == NT) break;
    const int nb = min(BATCH, cnt - b0);
    for (int j = tid; j < nb; j += NT) {
      stage_entry<false>(table, ld, patch_gsid[start + b0 + j], ox, oy, &s_p[j], &s_q[j],
                         &s_gb[j]);
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      if (max_tau(tau) < TAU_STOP) break;
      const float4 p = s_p[k];
      const float4 q = s_q[k];
      const float2 gb = s_gb[k];
      float dx[QX], dy[QY];
#pragma unroll
      for (int a = 0; a < QX; ++a) dx[a] = p.x - (float)(lx + a);
#pragma unroll
      for (int b = 0; b < QY; ++b) dy[b] = p.y - (float)(ly + b);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        // branch-free: the four pixels' chains interleave
        const float ap = blend_alpha(q, blend_exponent(p, q.x, dx[i % QX], dy[i / QX]));
        const bool use = tau[i] >= TAU_STOP && ap >= ALPHA_SKIP;  // tau < 1e-4: done
        const float w = use ? tau[i] * ap : 0.0f;
        c0[i] = fmaf(w, q.w, c0[i]);
        c1[i] = fmaf(w, gb.x, c1[i]);
        c2[i] = fmaf(w, gb.y, c2[i]);
        cont[i] = use ? b0 + k + 1 : cont[i];
        tau[i] = use ? tau[i] * (1.0f - ap) : tau[i];
      }
    }
  }

  const size_t hw = (size_t)height * width;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int px = tx * TILE + lx + i % QX, py = ty * TILE + ly + i / QX;
    if (px < width && py < height) {
      const size_t pix = (size_t)py * width + px;
      image[pix] = c0[i];
      image[hw + pix] = c1[i];
      image[2 * hw + pix] = c2[i];
      final_tau[pix] = tau[i];
      contrib[pix] = cont[i];
    }
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
  rasterize_fwd_kernel<<<n_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ld, patch_gsid, tile_start, tile_cnt, gx, width, height, image,
      final_tau, contrib);
  return static_cast<int>(cudaGetLastError());
}

const void* egs_blend::fwd_kernel() {
  return reinterpret_cast<const void*>(rasterize_fwd_kernel);
}

// K4's (kernel 0) or K5's (kernel 1) registers a thread and resident blocks
// of NT threads an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// written to out[0..1].
extern "C" int egs_rasterize_info(int kernel, int* out) {
  if (kernel != 0 && kernel != 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel == 0 ? egs_blend::fwd_kernel() : egs_blend::bwd_kernel();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, NT, 0));
}
