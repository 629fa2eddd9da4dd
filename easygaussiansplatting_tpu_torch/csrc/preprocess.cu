// K1: fused preprocess forward — stages 1-5 for one camera in one pass.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/preprocess.py
// `_fwd_kernel` (reached through `_fwd_call` and `fused_preprocess`). Plain
// version: ops/stages.py (assembled into the same table by
// ops/kernels/preprocess.py::preprocess_plain).
//
// What bounds it on an H100: bytes. Each gaussian reads 4*(11 + S) bytes of
// parameters (S = 3 * basis count, 48 at SH degree 3) and writes one 48-byte
// table row, against ~330 FP32 operations: at N = 65,536 that is ~18.6 MB
// and ~22 MFLOP, 0.0056 ms at 3.35 TB/s. A thread per gaussian reading its
// own rows would touch a 32-byte sector per lane at every load of its
// 192-byte SH row and write its table row at a 48-byte stride (the TPU's
// [C,R,128] component planes existed only to fill the VPU's 8x128 vregs).
// So, on the pattern of K2 (preprocess_bwd.cu):
//   * A block owns B = 128 consecutive gaussians. Their rotations,
//     positions, scales and opacities (44 contiguous bytes a gaussian), then
//     their SH slice (B*192 contiguous bytes at degree 3), arrive in shared
//     memory by 16-byte cp.async in two groups, consecutive lanes on
//     consecutive addresses (preprocess_rows.cuh). SH rows are padded to an
//     odd number of float4s where their width is a multiple of 4 floats (52
//     at degree 3), so a thread's 16-byte reads of its own row are
//     conflict-free; odd widths (degrees 0, 2, 4) keep their odd stride and
//     are read as floats.
//   * Each thread computes stages 1-3 and 5 of its gaussian as soon as the
//     first group has landed, while the SH slice is still on its way, then
//     its colour; it leaves its table row in shared memory (a stride of 3
//     float4s, conflict-free), and the block's rows leave as 16-byte stores
//     to consecutive addresses.
// Every array must be 16-byte aligned (the wrapper checks). The camera and
// the SH constants ride in the by-value kernel parameters; the basis count
// is a template parameter so the SH basis stays in registers.
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

#include "preprocess_rows.cuh"

namespace {

// The block's dynamic shared memory in floats: SH rows, rotations, table
// rows, positions, scales, opacities (each region a multiple of 128 floats,
// so each starts 16-byte aligned).
template <int DEG>
constexpr int smem_floats() {
  return B * (ShRow<DEG>::SW + 4 + TABLE_COLS + 3 + 3 + 1);
}

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

// Stages 1-3 and 5 of one gaussian (its table row but the colour) and its
// unit view direction, from its rows in shared memory.
struct Geometry {
  float4 head;                         // ux, uy, conic a, conic b
  float conic_c, depth, ext_x, ext_y;  // the rest of the row but alpha and rgb
  float dx, dy, dz;                    // the view direction
};

__device__ __forceinline__ Geometry geometry(const PreParams& p, int t, const float* s_pw,
                                             const float* s_sc, const float* s_rot) {
  const float* cam = p.cam;
  const float r00 = cam[0], r01 = cam[1], r02 = cam[2];
  const float r10 = cam[3], r11 = cam[4], r12 = cam[5];
  const float r20 = cam[6], r21 = cam[7], r22 = cam[8];
  const float t0 = cam[9], t1 = cam[10], t2 = cam[11];
  const float w0 = cam[12], w1 = cam[13], w2 = cam[14];
  const float fx = cam[15], fy = cam[16], cx = cam[17], cy = cam[18];
  const float limx = cam[19], limy = cam[20];

  const float px = s_pw[3 * t], py = s_pw[3 * t + 1], pz = s_pw[3 * t + 2];
  const float sx = s_sc[3 * t], sy = s_sc[3 * t + 1], sz = s_sc[3 * t + 2];
  const float4 q = reinterpret_cast<const float4*>(s_rot)[t];
  const float qw = q.x, qx = q.y, qy = q.z, qz = q.w;

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

  // the view ray for stage 4
  const float rx = px - w0, ry = py - w1, rz = pz - w2;
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  const float inv = 1.0f / fmaxf(norm, 1e-12f);

  // stage 5: conic + 3-sigma extents
  const float det = ca * cc - cb * cb;
  const float det_safe = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float det_inv = 1.0f / det_safe;

  Geometry g;
  g.head = make_float4(ux, uy, cc * det_inv, -cb * det_inv);
  g.conic_c = ca * det_inv;
  g.depth = pcz;
  g.ext_x = ceilf(3.0f * sqrtf(fabsf(ca)));
  g.ext_y = ceilf(3.0f * sqrtf(fabsf(cc)));
  g.dx = rx * inv;
  g.dy = ry * inv;
  g.dz = rz * inv;
  return g;
}

// Stage 4 of one gaussian, SH -> RGB along its view direction, and its
// table row to `row`: colour c sums basis[k] * sh[3k + c] over k in order,
// the SH row read front to back.
template <int DEG>
__device__ __forceinline__ void colour_row(const PreParams& p, const Geometry& g,
                                           const float* sh, float alpha, float* row) {
  constexpr int NB = ShRow<DEG>::NB, W = ShRow<DEG>::W;
  float basis[NB];
  sh_basis<DEG>(p.shc, g.dx, g.dy, g.dz, basis);
  float acc[3];
  auto take = [&](int j, float v) {  // v = sh[j], j = 3k + c
    acc[j % 3] = j < 3 ? basis[0] * v : acc[j % 3] + basis[j / 3] * v;
  };
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j4 = 0; j4 < W / 4; ++j4) {
      const float4 v = reinterpret_cast<const float4*>(sh)[j4];
      take(4 * j4, v.x);
      take(4 * j4 + 1, v.y);
      take(4 * j4 + 2, v.z);
      take(4 * j4 + 3, v.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) take(j, sh[j]);
  }
  float4* out = reinterpret_cast<float4*>(row);
  out[0] = g.head;
  out[1] = make_float4(g.conic_c, alpha, 0.5f + acc[0], 0.5f + acc[1]);
  out[2] = make_float4(0.5f + acc[2], g.depth, g.ext_x, g.ext_y);
}

template <int DEG>
__global__ void __launch_bounds__(B)
preprocess_fwd_kernel(const __grid_constant__ PreParams p, const float* __restrict__ pws,
                      const float* __restrict__ shs, const float* __restrict__ alphas,
                      const float* __restrict__ scales, const float* __restrict__ rots,
                      float* __restrict__ out, int n) {
  constexpr int W = ShRow<DEG>::W, SW = ShRow<DEG>::SW;
  extern __shared__ float4 s_mem[];
  float* s_sh = reinterpret_cast<float*>(s_mem);  // [B][SW]
  float* s_rot = s_sh + B * SW;                    // [B][4]
  float* s_row = s_rot + B * 4;                    // [B][TABLE_COLS]: the table rows
  float* s_pw = s_row + B * TABLE_COLS;            // [B][3]
  float* s_sc = s_pw + B * 3;                      // [B][3]
  float* s_al = s_sc + B * 3;                      // [B]
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * B;
  const int nb = min(B, n - i0);
  // two groups of copies: the geometry's slices (44 bytes a gaussian)
  // first, then the SH slice, which lands while the geometry is computed
  stage<4, 4>(s_rot, rots + (size_t)i0 * 4, nb * 4);
  stage<3, 3>(s_pw, pws + (size_t)i0 * 3, nb * 3);
  stage<3, 3>(s_sc, scales + (size_t)i0 * 3, nb * 3);
  stage<1, 1>(s_al, alphas + i0, nb);
  cp_async_commit();
  stage<W, SW>(s_sh, shs + (size_t)i0 * W, nb * W);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  Geometry g;
  if (t < nb) g = geometry(p, t, s_pw, s_sc, s_rot);
  cp_async_wait<0>();
  __syncthreads();
  if (t < nb) colour_row<DEG>(p, g, s_sh + t * SW, s_al[t], s_row + t * TABLE_COLS);
  __syncthreads();
  unstage(out + (size_t)i0 * TABLE_COLS, s_row, nb * TABLE_COLS);
}

template <int DEG>
const void* kernel_of() {
  return reinterpret_cast<const void*>(preprocess_fwd_kernel<DEG>);
}

// The kernel and its dynamic shared memory for a basis count, the attribute
// for more than 48 KB set on first use; false for a count K1 does not take.
bool kernel_for(int n_bases, const void** fn, size_t* smem) {
  int deg;
  switch (n_bases) {
    case 1: deg = 0; *fn = kernel_of<0>(); *smem = smem_floats<0>(); break;
    case 4: deg = 1; *fn = kernel_of<1>(); *smem = smem_floats<1>(); break;
    case 9: deg = 2; *fn = kernel_of<2>(); *smem = smem_floats<2>(); break;
    case 16: deg = 3; *fn = kernel_of<3>(); *smem = smem_floats<3>(); break;
    case 25: deg = 4; *fn = kernel_of<4>(); *smem = smem_floats<4>(); break;
    case 36: deg = 5; *fn = kernel_of<5>(); *smem = smem_floats<5>(); break;
    default: return false;
  }
  *smem *= sizeof(float);
  static bool attribute_set[6] = {};
  if (!attribute_set[deg]) {
    if (cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem) !=
        cudaSuccess)
      return false;
    attribute_set[deg] = true;
  }
  return true;
}

}  // namespace

// pws [N,3], shs [N,3*n_bases], alphas [N], scales [N,3], rots [N,4]: float32
// device pointers, contiguous, 16-byte aligned. cam_host: 21 floats,
// shc_host: 36 floats, both host memory (copied into the kernel
// parameters). out: [N,12] float32 device, 16-byte aligned.
extern "C" int egs_preprocess_fwd(const float* pws, const float* shs,
                                  const float* alphas, const float* scales,
                                  const float* rots, const float* cam_host,
                                  const float* shc_host, float* out, int n,
                                  int n_bases, void* stream) {
  PreParams p;
  memcpy(p.cam, cam_host, sizeof(p.cam));
  memcpy(p.shc, shc_host, sizeof(p.shc));
  const void* fn;
  size_t smem;
  if (!kernel_for(n_bases, &fn, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  if (!(aligned(pws, 16) && aligned(shs, 16) && aligned(alphas, 16) && aligned(scales, 16) &&
        aligned(rots, 16) && aligned(out, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  void* args[] = {&p, (void*)&pws, (void*)&shs, (void*)&alphas, (void*)&scales,
                  (void*)&rots, (void*)&out, (void*)&n};
  cudaError_t e = cudaLaunchKernel(fn, dim3((n + B - 1) / B), dim3(B), args, smem,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the compiled K1 kernel for n_bases takes on the card, written to
// out[0..4]: registers a thread, shared bytes a block (static and dynamic),
// local (spill) bytes a thread, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and threads a block.
extern "C" int egs_preprocess_fwd_info(int n_bases, int* out) {
  const void* fn;
  size_t smem;
  if (!kernel_for(n_bases, &fn, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[4] = B;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], fn, B, smem));
}
