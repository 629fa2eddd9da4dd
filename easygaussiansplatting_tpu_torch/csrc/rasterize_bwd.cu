// K5: stage-6 backward — one 64-thread CTA per 16x16 tile, a 2x2 pixel quad
// per thread, as K4.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/kernels.py
// `backward_kernel` (reached through ops/pallas/rasterize.py `_bwd_call` and
// `_raster_table_bwd`), non-interleaved path. Plain version:
// ops/rasterize_tiled.py::rasterize_tiled_bwd with ops/blend.py
// ::blend_chunk_bwd.
//
// The TPU kernel streams (chunk x tile) segments in reverse grid order,
// recovers the transmittance in log space with triangular MXU contractions
// and revisits chunk-aligned gradient blocks. None of that carries over. The
// shape, after the reference's drawB:
//   * one 64-thread block per tile; thread t replays the four pixels of quad
//     (t % 8, t / 8), tile-local coordinates (the u gradient is
//     shift-invariant, docs/backward.md B.4);
//   * the tile's list is walked BACK TO FRONT in batches of BATCH entries
//     staged in shared memory exactly as K4 stages them (blend.cuh); the walk
//     starts at the tile's largest contributor count, so entries no pixel
//     reached are never read (B.2.3);
//   * a warp skips an entry that none of its pixels reached inside the
//     entry's cutoff (blend.cuh); otherwise each pixel, from its stored
//     final tau, skips entries at positions >= its contrib, re-applies
//     alpha' >= 0.002 through K4's evaluation (blend.cuh), recovers the
//     transmittance in front of each entry by division, tau /= (1 - alpha')
//     (B.2.1; a reciprocal of the denominator clamped at 1e-6, then a
//     multiply), and carries g . (colour behind) (B.2.2), branch-free: a
//     skipped pair acts as alpha' 0, so it multiplies tau by 1 and adds
//     zeros;
//   * per entry it forms d alpha' (B.1.2), the clamp and maha > 0 masks
//     (B.3), and nine terms: the offset moments dm*dx, dm*dy, dm*dx^2,
//     dm*dx*dy, dm*dy^2 of dm = d loss / d maha (B.4; summed without its
//     factor -0.5, which the entry's sums take once), dalpha' * alpha' for
//     d alpha, and the colour weights times g (B.5.1), summed over the
//     thread's four pixels in registers;
//   * the warp then reduces the nine sums across its 32 lanes by a
//     reduce-scatter: at each of the five butterfly distances a lane keeps
//     half of its values and sends the other half, so 9 values cost
//     5 + 3 + 2 + 1 + 1 = 12 shuffles (a 5-step butterfly a term would
//     take 45, and with a pixel a thread eight warps a tile: 360 a tile
//     and entry, against 24 here), and a warp with no live pair skips it;
//   * nine lanes of each warp leave their term in shared memory; after the
//     batch, thread j adds the two warps' terms of entry j and writes the
//     patch's nine gradients once. A patch belongs to exactly one tile and
//     every sum runs in a fixed order, so there are no atomics and the
//     result is the same on every run.
// Pixels past W or H (the last tile column of a 979-wide image) have no
// colour gradient and no contributors: they add zeros.
//
// What bounds it on an H100: instruction issue. Each (entry, pixel) pair a
// warp evaluates costs K4's exponent, one ex2 and one reciprocal on the MUFU
// and ~35 FP32 operations and selects (chip_smoke.py's k5_bound counts the
// ones the run's data needs); the reduction adds 12 shuffles, 24 selects and
// 12 adds per (entry, warp). The gather of table rows is a few MB.
//
// Output: grads [9, M] float32, rows d ux, uy, conic a, b, c, alpha, r, g,
// b; the caller zero-fills it, and only the slots of entries some pixel of
// their tile reached are written.

#include <cuda_runtime.h>

#include "blend.cuh"

namespace {

using namespace egs_blend;

constexpr int WARPS = NT / 32;
constexpr int BATCH = 64;  // entries per staged batch, one a thread
static_assert(BATCH == NT, "a batch stages one entry a thread");
constexpr int TERMS = 9;
constexpr unsigned FULL = 0xffffffffu;
// The term a lane holds after reduce9, by lane / 2 (4 bits each; 15: none).
// The reduce-scatter splits the 9 terms 5|4, then 3|2, 2|1, 1|1 (bits 4..1
// of the lane pick the upper part); the last distance is a plain butterfly.
constexpr unsigned long long TERM_OF_LANE = 0xfff8f765ff43f210ull;

// Sum v[0..8] over the warp's 32 lanes in a fixed order; returns the sum of
// term TERM_OF_LANE[lane / 2] (garbage where that is 15).
__device__ __forceinline__ float reduce9(const float (&v)[TERMS], int lane) {
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4, u2 = lane & 2;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float hi = i < 4 ? v[5 + i] : 0.0f;
    a[i] = (u16 ? hi : v[i]) + __shfl_xor_sync(FULL, u16 ? v[i] : hi, 16);
  }
  float b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hi = i < 2 ? a[3 + i] : 0.0f;
    b[i] = (u8 ? hi : a[i]) + __shfl_xor_sync(FULL, u8 ? a[i] : hi, 8);
  }
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float hi = i < 1 ? b[2] : 0.0f;
    c[i] = (u4 ? hi : b[i]) + __shfl_xor_sync(FULL, u4 ? b[i] : hi, 4);
  }
  float d = (u2 ? c[1] : c[0]) + __shfl_xor_sync(FULL, u2 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(FULL, d, 1);
}

__global__ void __launch_bounds__(NT)
rasterize_bwd_kernel(const float* __restrict__ table, int ld,
                     const int* __restrict__ patch_gsid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_cnt, int gx, int width, int height,
                     const float* __restrict__ g_image,
                     const float* __restrict__ final_tau,
                     const int* __restrict__ contrib, float* __restrict__ grads,
                     int m) {
  __shared__ float4 s_p[BATCH];
  __shared__ float4 s_q[BATCH];
  __shared__ float2 s_gb[BATCH];
  __shared__ float s_part[BATCH][WARPS][TERMS];
  __shared__ int s_wmax[WARPS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = t % gx, ty = t / gx;
  const int lx = QX * (tid % COLS), ly = QY * (tid / COLS);
  const float ox = (float)(tx * TILE), oy = (float)(ty * TILE);
  const int start = tile_start[t];
  const int my_term = (int)((TERM_OF_LANE >> (4 * (lane >> 1))) & 15);
  const bool writer = (lane & 1) == 0 && my_term < TERMS;

  float tau[PIX], gag[PIX], g0[PIX], g1[PIX], g2[PIX];
  int cont[PIX];
  int tmax = 0;
  const size_t hw = (size_t)height * width;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int px = tx * TILE + lx + i % QX, py = ty * TILE + ly + i / QX;
    tau[i] = 1.0f;
    gag[i] = g0[i] = g1[i] = g2[i] = 0.0f;  // g . (blended colour of every entry behind)
    cont[i] = 0;
    if (px < width && py < height) {
      const size_t pix = (size_t)py * width + px;
      tau[i] = final_tau[pix];
      cont[i] = contrib[pix];
      g0[i] = g_image[pix];
      g1[i] = g_image[hw + pix];
      g2[i] = g_image[2 * hw + pix];
    }
    tmax = max(tmax, cont[i]);
  }
  const int wmax = __reduce_max_sync(FULL, tmax);
  if (lane == 0) s_wmax[warp] = wmax;
  __syncthreads();
  int maxc = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) maxc = max(maxc, s_wmax[w]);
  maxc = min(maxc, tile_cnt[t]);  // never read past the tile's list

  for (int b0 = ((maxc - 1) / BATCH) * BATCH; maxc > 0 && b0 >= 0; b0 -= BATCH) {
    // the previous batch's entries and partials are fully consumed
    __syncthreads();
    const int nb = min(BATCH, maxc - b0);
    float4 raw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // conic a b c, alpha of entry tid
    if (tid < nb) {
      raw = stage_entry<true>(table, ld, patch_gsid[start + b0 + tid], ox, oy, &s_p[tid],
                              &s_q[tid], &s_gb[tid]);
    }
    __syncthreads();
    for (int k = nb - 1; k >= 0; --k) {
      const int pos = b0 + k;
      const float4 p = s_p[k];
      const float4 q = s_q[k];
      float dx[QX], dy[QY];
#pragma unroll
      for (int a = 0; a < QX; ++a) dx[a] = p.x - (float)(lx + a);
#pragma unroll
      for (int b = 0; b < QY; ++b) dy[b] = p.y - (float)(ly + b);
      float e[PIX];
      bool near = false;
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        e[i] = blend_exponent(p, q.x, dx[i % QX], dy[i / QX]);
        near |= pos < cont[i] && passes_cutoff(q, e[i]);
      }
      // a warp none of whose pixels reached the entry inside its cutoff
      // skips it
      if (!__any_sync(FULL, near)) {
        if (writer) s_part[k][warp][my_term] = 0.0f;
        continue;
      }
      const float2 gb = s_gb[k];
      float v[TERMS];
#pragma unroll
      for (int j = 0; j < TERMS; ++j) v[j] = 0.0f;
      bool live = false;
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        // branch-free: a dead pair acts as alpha' 0 and adds zeros
        const float ap0 = blend_alpha(q, e[i]);
        const bool lv = pos < cont[i] && ap0 >= ALPHA_SKIP;
        live |= lv;
        const float ap = lv ? ap0 : 0.0f;
        const float r = rcp_approx(fmaxf(1.0f - ap, 1e-6f));
        tau[i] *= r;  // transmittance in front of this entry
        const float contr = tau[i] * ap;
        const float cg = fmaf(q.w, g0[i], fmaf(gb.x, g1[i], gb.y * g2[i]));
        const float dap = fmaf(tau[i], cg, -gag[i] * r);
        gag[i] = fmaf(contr, cg, gag[i]);
        const float dap_ap = ap < ALPHA_CLAMP ? dap * ap : 0.0f;
        v[5] += dap_ap;
        const float dm = e[i] < 0.0f ? dap_ap : 0.0f;  // -2 d loss / d maha, maha > 0
        const float mx = dm * dx[i % QX], my = dm * dy[i / QX];
        v[0] += mx;
        v[1] += my;
        v[2] = fmaf(mx, dx[i % QX], v[2]);
        v[3] = fmaf(mx, dy[i / QX], v[3]);
        v[4] = fmaf(my, dy[i / QX], v[4]);
        v[6] = fmaf(contr, g0[i], v[6]);
        v[7] = fmaf(contr, g1[i], v[7]);
        v[8] = fmaf(contr, g2[i], v[8]);
      }
      const float sum = __any_sync(FULL, live) ? reduce9(v, lane) : 0.0f;
      if (writer) s_part[k][warp][my_term] = sum;
    }
    __syncthreads();
    if (tid < nb) {
      float s[TERMS];
#pragma unroll
      for (int j = 0; j < TERMS; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += s_part[tid][w][j];
        s[j] = acc;
      }
      // the moments' factor -0.5 of d loss / d maha, once: a power of two,
      // so the result is the same as scaling every term
#pragma unroll
      for (int j = 0; j < 5; ++j) s[j] *= -0.5f;
      const size_t slot = (size_t)start + b0 + tid;
      grads[slot] = 2.0f * raw.x * s[0] + 2.0f * raw.y * s[1];
      grads[(size_t)m + slot] = 2.0f * raw.z * s[1] + 2.0f * raw.y * s[0];
      grads[2 * (size_t)m + slot] = s[2];
      grads[3 * (size_t)m + slot] = 2.0f * s[3];
      grads[4 * (size_t)m + slot] = s[4];
      grads[5 * (size_t)m + slot] = s[5] / fmaxf(raw.w, 1e-12f);
      grads[6 * (size_t)m + slot] = s[6];
      grads[7 * (size_t)m + slot] = s[7];
      grads[8 * (size_t)m + slot] = s[8];
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
  rasterize_bwd_kernel<<<n_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ld, patch_gsid, tile_start, tile_cnt, gx, width, height, g_image, final_tau,
      contrib, grads, m);
  return static_cast<int>(cudaGetLastError());
}

const void* egs_blend::bwd_kernel() {
  return reinterpret_cast<const void*>(rasterize_bwd_kernel);
}
