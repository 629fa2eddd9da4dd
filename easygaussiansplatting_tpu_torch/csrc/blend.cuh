// Stage-6 blend pieces shared by K4 (rasterize_fwd.cu) and K5
// (rasterize_bwd.cu).
//
// The backward replays the forward's threshold decisions: maha and alpha'
// decide which entries count (the 0.002 skip, the 0.99 clamp, the 1e-4
// stop). Both kernels evaluate them through the one inline function below,
// built with the same flags, so a pixel on a threshold gets the same
// contributor set in both.

#pragma once

#include <cuda_runtime.h>

namespace egs_blend {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_SKIP = 0.002f;
constexpr float TAU_STOP = 1e-4f;

struct Alpha {
  float ap;    // alpha' = min(0.99, alpha * exp(-0.5 * max(0, maha)))
  float dx;    // mean minus pixel, tile-local
  float dy;
  float maha;  // the raw Mahalanobis form, before the clamp at 0
};

// One (entry, pixel) pair: xy is the entry's mean shifted by the tile origin,
// q its conic (a, b, c) and alpha, (fx, fy) the tile-local pixel.
__device__ __forceinline__ Alpha blend_alpha(float2 xy, float4 q, float fx, float fy) {
  const float dx = xy.x - fx;
  const float dy = xy.y - fy;
  const float maha = q.x * dx * dx + q.z * dy * dy + 2.0f * q.y * dx * dy;
  const float ap = fminf(ALPHA_CLAMP, q.w * expf(-0.5f * fmaxf(0.0f, maha)));
  return {ap, dx, dy, maha};
}

// Stage the table row of gaussian g (ux uy ca cb | cc alpha r g | b ..., ld
// floats per row, ld % 4 == 0) with its mean shifted by the tile origin
// (ox, oy). g < 0 stages alpha 0: every pixel skips it.
__device__ __forceinline__ void load_entry(const float* __restrict__ table, int ld, int g,
                                           float ox, float oy, float2* xy, float4* conic,
                                           float4* rgb) {
  if (g >= 0) {
    const float4* row = reinterpret_cast<const float4*>(table + (size_t)g * ld);
    const float4 r0 = row[0], r1 = row[1];
    const float b = table[(size_t)g * ld + 8];
    *xy = make_float2(r0.x - ox, r0.y - oy);
    *conic = make_float4(r0.z, r0.w, r1.x, r1.y);
    *rgb = make_float4(r1.z, r1.w, b, 0.0f);
  } else {
    *xy = make_float2(0.0f, 0.0f);
    *conic = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *rgb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace egs_blend
