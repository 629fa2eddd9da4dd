// Stage-6 blend pieces shared by K4 (rasterize_fwd.cu) and K5
// (rasterize_bwd.cu).
//
// The backward replays the forward's threshold decisions: alpha' decides
// which entries count (the 0.002 skip, the 0.99 clamp, the 1e-4 stop). Both
// kernels stage entries with stage_entry and evaluate alpha' through
// blend_alpha below, built with the same flags, so a pixel on a threshold
// gets the same contributor set in both.
//
// Both kernels give a thread the QX x QY pixel block (QX * (t % COLS) + a,
// QY * (t / COLS) + b) of its tile, a < QX, b < QY, COLS = TILE / QX:
// NT = 64 threads a tile for the 2x2 quads, warp 0 on the top eight pixel
// rows, warp 1 on the bottom eight.

#pragma once

#include <cuda_runtime.h>

namespace egs_blend {

constexpr int TILE = 16;
constexpr int QX = 2, QY = 2;            // a thread's pixels: QX columns, QY rows
constexpr int PIX = QX * QY;
constexpr int COLS = TILE / QX;          // threads across a tile row
constexpr int NT = TILE * TILE / PIX;    // threads a tile
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_SKIP = 0.002f;
constexpr float TAU_STOP = 1e-4f;
// -0.5 * log2(e): the conic is staged pre-scaled by it, so the exponent of
// alpha' = alpha * 2^e comes out of the quadratic form directly
constexpr float NEG_HALF_LOG2E = -0.72134752044448170f;
// The per-entry cutoff: where e < log2(ALPHA_SKIP / alpha) - CUTOFF_MARGIN,
// alpha' < ALPHA_SKIP * 2^-CUTOFF_MARGIN (0.99931 of the skip threshold),
// far below what the rounding of ex2.approx (2^-22 relative), log2 and the
// products can reach. K5 skips an entry for a warp whose pixels all lie past
// it, and no decision changes: a pair nearer the edge takes the exact test.
constexpr float CUTOFF_MARGIN = 1e-3f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x within an ulp (the MUFU reciprocal, no IEEE rounding fix-up)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage the table row of gaussian g (ux uy ca cb | cc alpha r g | b ..., ld
// floats per row, ld % 4 == 0) as sp = (x, y, ea, eb), sq = (ec, alpha, cut,
// r), sgb = (g, b): the mean shifted by the tile origin (ox, oy), the conic
// pre-scaled (ea = -0.5 log2e a, eb = -log2e b, ec = -0.5 log2e c) and, with
// CUTOFF (K5), the cutoff on e; without it (K4, which never reads it) cut is
// 0. g < 0 stages alpha 0 and an infinite cutoff: every pixel skips it.
// Returns the raw conic and alpha (a, b, c, alpha), which K5's gradients need.
template <bool CUTOFF>
__device__ __forceinline__ float4 stage_entry(const float* __restrict__ table, int ld, int g,
                                              float ox, float oy, float4* sp, float4* sq,
                                              float2* sgb) {
  if (g < 0) {
    *sp = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *sq = make_float4(0.0f, 0.0f, __int_as_float(0x7f800000), 0.0f);
    *sgb = make_float2(0.0f, 0.0f);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float4* row = reinterpret_cast<const float4*>(table + (size_t)g * ld);
  const float4 r0 = __ldg(row), r1 = __ldg(row + 1);
  const float b = __ldg(table + (size_t)g * ld + 8);
  const float alpha = r1.y;
  // log2(0.002 / alpha): +inf for alpha 0, so such an entry is always cut
  const float cut = CUTOFF ? __log2f(ALPHA_SKIP) - __log2f(alpha) - CUTOFF_MARGIN : 0.0f;
  *sp = make_float4(r0.x - ox, r0.y - oy, NEG_HALF_LOG2E * r0.z, 2.0f * NEG_HALF_LOG2E * r0.w);
  *sq = make_float4(NEG_HALF_LOG2E * r1.x, alpha, cut, r1.z);
  *sgb = make_float2(r1.w, b);
  return make_float4(r0.z, r0.w, r1.x, alpha);
}

// e = -0.5 log2(e) * maha for the offset (dx, dy) = mean - pixel: e < 0
// exactly where maha > 0, up to rounding at maha = 0.
__device__ __forceinline__ float blend_exponent(const float4& p, float ec, float dx,
                                                float dy) {
  return fmaf(dx, fmaf(p.z, dx, p.w * dy), ec * dy * dy);
}

// alpha' = min(0.99, alpha * 2^min(0, e)); the pair is skipped where it is
// below ALPHA_SKIP.
__device__ __forceinline__ float blend_alpha(const float4& q, float e) {
  return fminf(ALPHA_CLAMP, q.y * ex2_approx(fminf(e, 0.0f)));
}

// False where the entry's cutoff proves blend_alpha(q, e) < ALPHA_SKIP.
__device__ __forceinline__ bool passes_cutoff(const float4& q, float e) { return e >= q.z; }

// The blend kernels, for egs_rasterize_info: each source returns its own
// (they live in anonymous namespaces); K4's a CTA a tile, or its chunks.
const void* fwd_kernel(bool split);
const void* bwd_kernel();

}  // namespace egs_blend
