// K1: fused preprocess forward — stages 1-5 for one camera in one pass.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/preprocess.py
// `_fwd_kernel` (reached through `_fwd_call` and `fused_preprocess`). Plain
// version: ops/stages.py (assembled into the same table by
// ops/kernels/preprocess.py::preprocess_plain).
//
// What bounds it on an H100: bytes. Each gaussian reads 4*(11 + S) bytes of
// parameters (S = 3 * basis count, 48 at SH degree 3) and writes one 48-byte
// table row, against ~300 FP32 operations: at N = 65,536 that is ~18.6 MB
// and ~20 MFLOP, a few microseconds at 3.35 TB/s — so at this size the launch
// itself dominates. Design: one thread per gaussian (the TPU's [C,R,128]
// component-plane layout existed only to fill the VPU's 8x128 vregs); the
// camera and the SH constants ride in the by-value kernel parameters; the
// basis count is a template parameter so the SH basis stays in registers;
// the row is written as three 16-byte stores.
//
// Numerics: the expressions and their order are those of `_forward_rows`
// (and of ops/stages.py). This file is compiled with -fmad=false so nvcc does
// not contract multiply-adds: the chain then rounds where the plain PyTorch
// chain rounds, which matters because the extents end in ceil().
//
// Output row (TABLE_COLS = 12 floats):
//   0 ux, 1 uy, 2 conic a, 3 conic b, 4 conic c, 5 alpha, 6 r, 7 g, 8 b,
//   9 depth (camera z), 10 extent x, 11 extent y.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int TABLE_COLS = 12;
constexpr float MIN_DEPTH = 0.2f;

struct PreParams {
  float cam[21];  // Rcw (9, row-major) tcw (3) twc (3) fx fy cx cy limx limy
  float shc[36];  // SH constants in basis order (utils/sh.py SH_CONSTS)
};

// Real SH basis, degrees 0..DEG, in the order and evaluation order of
// utils/sh.py sh_basis.
template <int DEG>
__device__ __forceinline__ void sh_basis(const float* c, float x, float y,
                                         float z, float* b) {
  b[0] = c[0];
  if constexpr (DEG >= 1) {
    b[1] = c[1] * y;
    b[2] = c[2] * z;
    b[3] = c[3] * x;
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = c[4] * xy;
    b[5] = c[5] * yz;
    b[6] = c[6] * (2.0f * zz - xx - yy);
    b[7] = c[7] * xz;
    b[8] = c[8] * (xx - yy);
    if constexpr (DEG >= 3) {
      b[9] = c[9] * y * (3.0f * xx - yy);
      b[10] = c[10] * xy * z;
      b[11] = c[11] * y * (4.0f * zz - xx - yy);
      b[12] = c[12] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = c[13] * x * (4.0f * zz - xx - yy);
      b[14] = c[14] * z * (xx - yy);
      b[15] = c[15] * x * (xx - 3.0f * yy);
    }
    if constexpr (DEG >= 4) {
      b[16] = c[16] * xy * (xx - yy);
      b[17] = c[17] * yz * (3.0f * xx - yy);
      b[18] = c[18] * xy * (7.0f * zz - 1.0f);
      b[19] = c[19] * yz * (7.0f * zz - 3.0f);
      b[20] = c[20] * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = c[21] * xz * (7.0f * zz - 3.0f);
      b[22] = c[22] * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = c[23] * xz * (xx - 3.0f * yy);
      b[24] = c[24] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
    if constexpr (DEG >= 5) {
      const float zz2 = zz * zz;
      b[25] = c[25] * y * (5.0f * xx * xx - 10.0f * xx * yy + yy * yy);
      b[26] = c[26] * xy * z * (xx - yy);
      b[27] = c[27] * y * (3.0f * xx - yy) * (9.0f * zz - 1.0f);
      b[28] = c[28] * xy * z * (3.0f * zz - 1.0f);
      b[29] = c[29] * y * (14.0f * zz - 21.0f * zz2 - 1.0f);
      b[30] = c[30] * z * (70.0f * zz - 63.0f * zz2 - 15.0f);
      b[31] = c[31] * x * (14.0f * zz - 21.0f * zz2 - 1.0f);
      b[32] = c[32] * z * (xx - yy) * (3.0f * zz - 1.0f);
      b[33] = c[33] * x * (xx - 3.0f * yy) * (9.0f * zz - 1.0f);
      b[34] = c[34] * z * (xx * xx - 6.0f * xx * yy + yy * yy);
      b[35] = c[35] * x * (xx * xx - 10.0f * xx * yy + 5.0f * yy * yy);
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(256)
preprocess_fwd_kernel(PreParams p, const float* __restrict__ pws,
                      const float* __restrict__ shs,
                      const float* __restrict__ alphas,
                      const float* __restrict__ scales,
                      const float* __restrict__ rots, float* __restrict__ out,
                      int n) {
  constexpr int NB = (DEG + 1) * (DEG + 1);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* cam = p.cam;
  const float r00 = cam[0], r01 = cam[1], r02 = cam[2];
  const float r10 = cam[3], r11 = cam[4], r12 = cam[5];
  const float r20 = cam[6], r21 = cam[7], r22 = cam[8];
  const float t0 = cam[9], t1 = cam[10], t2 = cam[11];
  const float w0 = cam[12], w1 = cam[13], w2 = cam[14];
  const float fx = cam[15], fy = cam[16], cx = cam[17], cy = cam[18];
  const float limx = cam[19], limy = cam[20];

  const float px = pws[3 * i], py = pws[3 * i + 1], pz = pws[3 * i + 2];
  const float sx = scales[3 * i], sy = scales[3 * i + 1], sz = scales[3 * i + 2];
  const float qw = rots[4 * i], qx = rots[4 * i + 1];
  const float qy = rots[4 * i + 2], qz = rots[4 * i + 3];

  // stage 1: project
  const float pcx = px * r00 + py * r01 + pz * r02 + t0;
  const float pcy = px * r10 + py * r11 + pz * r12 + t1;
  const float pcz = px * r20 + py * r21 + pz * r22 + t2;
  const float zsafe = pcz >= MIN_DEPTH ? pcz : 1.0f;
  const float ux = pcx * fx / zsafe + cx;
  const float uy = pcy * fy / zsafe + cy;

  // stage 2: cov3d — columns of M = R(q) diag(s)
  const float m00 = (1.0f - 2.0f * (qy * qy + qz * qz)) * sx;
  const float m01 = (2.0f * (qx * qy - qz * qw)) * sy;
  const float m02 = (2.0f * (qx * qz + qy * qw)) * sz;
  const float m10 = (2.0f * (qx * qy + qz * qw)) * sx;
  const float m11 = (1.0f - 2.0f * (qx * qx + qz * qz)) * sy;
  const float m12 = (2.0f * (qy * qz - qx * qw)) * sz;
  const float m20 = (2.0f * (qx * qz - qy * qw)) * sx;
  const float m21 = (2.0f * (qy * qz + qx * qw)) * sy;
  const float m22 = (1.0f - 2.0f * (qx * qx + qy * qy)) * sz;
  const float sxx = m00 * m00 + m01 * m01 + m02 * m02;
  const float sxy = m00 * m10 + m01 * m11 + m02 * m12;
  const float sxz = m00 * m20 + m01 * m21 + m02 * m22;
  const float syy = m10 * m10 + m11 * m11 + m12 * m12;
  const float syz = m10 * m20 + m11 * m21 + m12 * m22;
  const float szz = m20 * m20 + m21 * m21 + m22 * m22;

  // stage 3: EWA cov2d with the 1.3 tan(fov) clamp
  const float cxv = fminf(fmaxf(pcx / zsafe, -limx), limx) * zsafe;
  const float cyv = fminf(fmaxf(pcy / zsafe, -limy), limy) * zsafe;
  const float z2 = zsafe * zsafe;
  const float jx0 = fx / zsafe;
  const float jx2 = -fx * cxv / z2;
  const float jy1 = fy / zsafe;
  const float jy2 = -fy * cyv / z2;
  const float a0 = jx0 * r00 + jx2 * r20;
  const float a1 = jx0 * r01 + jx2 * r21;
  const float a2 = jx0 * r02 + jx2 * r22;
  const float b0 = jy1 * r10 + jy2 * r20;
  const float b1 = jy1 * r11 + jy2 * r21;
  const float b2 = jy1 * r12 + jy2 * r22;
  const float sa0 = sxx * a0 + sxy * a1 + sxz * a2;
  const float sa1 = sxy * a0 + syy * a1 + syz * a2;
  const float sa2 = sxz * a0 + syz * a1 + szz * a2;
  const float sb0 = sxx * b0 + sxy * b1 + sxz * b2;
  const float sb1 = sxy * b0 + syy * b1 + syz * b2;
  const float sb2 = sxz * b0 + syz * b1 + szz * b2;
  const float ca = a0 * sa0 + a1 * sa1 + a2 * sa2 + 0.3f;
  const float cb = a0 * sb0 + a1 * sb1 + a2 * sb2;
  const float cc = b0 * sb0 + b1 * sb1 + b2 * sb2 + 0.3f;

  // stage 4: SH -> RGB along the view ray
  const float rx = px - w0, ry = py - w1, rz = pz - w2;
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  const float inv = 1.0f / fmaxf(norm, 1e-12f);
  float basis[NB];
  sh_basis<DEG>(p.shc, rx * inv, ry * inv, rz * inv, basis);
  const float* sh = shs + (size_t)i * (3 * NB);
  float col[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = basis[0] * sh[c];
#pragma unroll
    for (int k = 1; k < NB; ++k) acc = acc + basis[k] * sh[3 * k + c];
    col[c] = 0.5f + acc;
  }

  // stage 5: conic + 3-sigma extents
  const float det = ca * cc - cb * cb;
  const float det_safe = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float det_inv = 1.0f / det_safe;

  float4* row = reinterpret_cast<float4*>(out + (size_t)i * TABLE_COLS);
  row[0] = make_float4(ux, uy, cc * det_inv, -cb * det_inv);
  row[1] = make_float4(ca * det_inv, alphas[i], col[0], col[1]);
  row[2] = make_float4(col[2], pcz, ceilf(3.0f * sqrtf(fabsf(ca))),
                       ceilf(3.0f * sqrtf(fabsf(cc))));
}

}  // namespace

// pws [N,3], shs [N,3*n_bases], alphas [N], scales [N,3], rots [N,4]: float32
// device pointers, contiguous. cam_host: 21 floats, shc_host: 36 floats, both
// host memory (copied into the kernel parameters). out: [N,12] float32 device,
// 16-byte aligned.
extern "C" int egs_preprocess_fwd(const float* pws, const float* shs,
                                  const float* alphas, const float* scales,
                                  const float* rots, const float* cam_host,
                                  const float* shc_host, float* out, int n,
                                  int n_bases, void* stream) {
  PreParams p;
  memcpy(p.cam, cam_host, sizeof(p.cam));
  memcpy(p.shc, shc_host, sizeof(p.shc));
  if (n <= 0) return 0;
  const dim3 block(256), grid((n + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_bases) {
    case 1: preprocess_fwd_kernel<0><<<grid, block, 0, s>>>(p, pws, shs, alphas, scales, rots, out, n); break;
    case 4: preprocess_fwd_kernel<1><<<grid, block, 0, s>>>(p, pws, shs, alphas, scales, rots, out, n); break;
    case 9: preprocess_fwd_kernel<2><<<grid, block, 0, s>>>(p, pws, shs, alphas, scales, rots, out, n); break;
    case 16: preprocess_fwd_kernel<3><<<grid, block, 0, s>>>(p, pws, shs, alphas, scales, rots, out, n); break;
    case 25: preprocess_fwd_kernel<4><<<grid, block, 0, s>>>(p, pws, shs, alphas, scales, rots, out, n); break;
    case 36: preprocess_fwd_kernel<5><<<grid, block, 0, s>>>(p, pws, shs, alphas, scales, rots, out, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
