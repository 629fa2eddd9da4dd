// K2: VJP of the fused preprocess — stages 1-5 backward for one camera.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/preprocess.py
// `_bwd_kernel` (reached through `_bwd_call` and `_fused_bwd`), which runs
// jax.vjp of `_forward_rows` inside the kernel. Plain version: the autograd
// VJP of ops/stages.py (ops/kernels/preprocess.py::preprocess_bwd_plain).
//
// The math: one thread per gaussian recomputes the forward intermediates of
// `_forward_rows` and applies their transposes, derived by hand
// (docs/backward.md A.1-A.5): conic inverse, EWA covariance with the FoV
// clamp, projection, the quaternion-scale covariance, and the SH colour with
// its view-direction term. The SH basis is differentiated forward-mode (a
// value carried with its three partials), so every degree K1 supports (0-5)
// has its gradient without a second table of polynomials. Only the nine live
// table columns (u, conic, alpha, rgb) carry a cotangent: depth and the
// extents feed binning and the visibility mask, which take none. The camera
// takes no gradient, by contract.
//
// Guards, as autodiff of the forward has them: the clamp of x/z and y/z to
// +-1.3 tan(fov) passes no gradient outside it; a determinant below 1e-12
// (replaced by 1e-12) passes none to the covariance; a gaussian behind the
// camera uses z = 1 and passes none to its depth; the view-ray norm below
// 1e-12 passes none to the norm. Every discarded branch is a select between
// finite values, so a zero cotangent gives exactly zero, never NaN.
//
// What bounds it on an H100: bytes. Per gaussian it reads 4*(11 + S)
// parameter bytes and a 48-byte cotangent row and writes 4*(11 + S) gradient
// bytes (S = 48 at SH degree 3: 520 B), against some 600 FP32 operations: at
// N = 65,536 that is ~34 MB, ~0.010 ms at 3.35 TB/s. A thread per gaussian
// reading its own rows would touch a 32-byte sector per lane for 4 useful
// bytes at every load and store of its 192-byte SH row (and of the 12- and
// 48-byte rows), and L2 would see ~8x the write transactions the bytes need;
// a live array of the 16 basis values with their partials kept the kernel
// at up to 178 registers, one 256-thread block an SM. So:
//   * A block owns B = 128 consecutive gaussians. Their SH slice (B*192
//     contiguous bytes at degree 3), cotangent rows, positions and scales
//     arrive in shared memory by 16-byte cp.async, consecutive lanes on
//     consecutive addresses. SH rows are padded to a stride of an odd number
//     of float4s where their width is a multiple of 4 floats (52 at degree
//     3), so a thread's 16-byte reads of its own row are conflict-free; odd
//     widths (degrees 0, 2, 4) keep their odd stride and are read as floats.
//   * Each thread first forms dY_k = sum_c sh[k,c] gcol[c], then takes the
//     basis one term at a time (sh_basis hands each Y_k with its partials to
//     a callback), adding dY_k * grad Y_k to the view-direction gradient and
//     leaving Y_k in its own shared row.
//   * d_shs goes out as the outer product d_shs[i, 3k+c] = Y_k(i) gcol_c(i),
//     formed at store time from shared memory, as 16-byte stores over the
//     block's flat slice; d_pws and d_scales leave through shared memory the
//     same way, rots and d_rots move as one float4 a lane.
// Every array must be 16-byte aligned (the wrapper checks). The camera and
// the SH constants ride in the by-value kernel parameters; the degree is a
// template parameter.

#include <cuda_runtime.h>
#include <string.h>

#include "preprocess_rows.cuh"

namespace {

// A value and its partials along (x, y, z).
struct Dual {
  float v, dx, dy, dz;
  __device__ Dual(float v_ = 0.0f, float x = 0.0f, float y = 0.0f, float z = 0.0f)
      : v(v_), dx(x), dy(y), dz(z) {}
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.dx + b.dx, a.dy + b.dy, a.dz + b.dz);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.dx - b.dx, a.dy - b.dy, a.dz - b.dz);
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.v * b.dx + a.dx * b.v, a.v * b.dy + a.dy * b.v,
              a.v * b.dz + a.dz * b.v);
}
__device__ __forceinline__ Dual operator*(float s, Dual a) {
  return Dual(s * a.v, s * a.dx, s * a.dy, s * a.dz);
}
__device__ __forceinline__ Dual operator+(Dual a, float s) { return Dual(a.v + s, a.dx, a.dy, a.dz); }
__device__ __forceinline__ Dual operator-(Dual a, float s) { return Dual(a.v - s, a.dx, a.dy, a.dz); }

// The block's dynamic shared memory in floats: SH rows, cotangent rows,
// positions, scales, colour cotangents (padded to 4).
template <int DEG>
constexpr int smem_floats() {
  return B * (ShRow<DEG>::SW + TABLE_COLS + 3 + 3 + 4);
}

// Real SH basis, degrees 0..DEG, as utils/sh.py sh_basis writes it (and
// csrc/preprocess.cu evaluates it), here over Dual values, handed to
// emit(k, Y_k) one term at a time in basis order, so no array of them is
// live.
template <int DEG, class Emit>
__device__ __forceinline__ void sh_basis(const float* c, Dual x, Dual y, Dual z, Emit&& emit) {
  emit(0, Dual(c[0]));
  if constexpr (DEG >= 1) {
    emit(1, c[1] * y);
    emit(2, c[2] * z);
    emit(3, c[3] * x);
  }
  if constexpr (DEG >= 2) {
    const Dual xx = x * x, yy = y * y, zz = z * z;
    const Dual xy = x * y, yz = y * z, xz = x * z;
    emit(4, c[4] * xy);
    emit(5, c[5] * yz);
    emit(6, c[6] * (2.0f * zz - xx - yy));
    emit(7, c[7] * xz);
    emit(8, c[8] * (xx - yy));
    if constexpr (DEG >= 3) {
      emit(9, c[9] * y * (3.0f * xx - yy));
      emit(10, c[10] * xy * z);
      emit(11, c[11] * y * (4.0f * zz - xx - yy));
      emit(12, c[12] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy));
      emit(13, c[13] * x * (4.0f * zz - xx - yy));
      emit(14, c[14] * z * (xx - yy));
      emit(15, c[15] * x * (xx - 3.0f * yy));
    }
    if constexpr (DEG >= 4) {
      emit(16, c[16] * xy * (xx - yy));
      emit(17, c[17] * yz * (3.0f * xx - yy));
      emit(18, c[18] * xy * (7.0f * zz - 1.0f));
      emit(19, c[19] * yz * (7.0f * zz - 3.0f));
      emit(20, c[20] * (zz * (35.0f * zz - 30.0f) + 3.0f));
      emit(21, c[21] * xz * (7.0f * zz - 3.0f));
      emit(22, c[22] * (xx - yy) * (7.0f * zz - 1.0f));
      emit(23, c[23] * xz * (xx - 3.0f * yy));
      emit(24, c[24] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy)));
    }
    if constexpr (DEG >= 5) {
      const Dual zz2 = zz * zz;
      emit(25, c[25] * y * (5.0f * xx * xx - 10.0f * xx * yy + yy * yy));
      emit(26, c[26] * xy * z * (xx - yy));
      emit(27, c[27] * y * (3.0f * xx - yy) * (9.0f * zz - 1.0f));
      emit(28, c[28] * xy * z * (3.0f * zz - 1.0f));
      emit(29, c[29] * y * (14.0f * zz - 21.0f * zz2 - 1.0f));
      emit(30, c[30] * z * (70.0f * zz - 63.0f * zz2 - 15.0f));
      emit(31, c[31] * x * (14.0f * zz - 21.0f * zz2 - 1.0f));
      emit(32, c[32] * z * (xx - yy) * (3.0f * zz - 1.0f));
      emit(33, c[33] * x * (xx - 3.0f * yy) * (9.0f * zz - 1.0f));
      emit(34, c[34] * z * (xx * xx - 6.0f * xx * yy + yy * yy));
      emit(35, c[35] * x * (xx * xx - 10.0f * xx * yy + 5.0f * yy * yy));
    }
  }
}

// One gaussian's backward, thread t of the block, from its rows in shared
// memory: leaves d_pws and d_scales over its pws and scales, Y_k in the
// first NB floats of its SH row and its colour cotangents in s_g; returns
// d_rots (w, x, y, z).
template <int DEG>
__device__ __forceinline__ float4 gaussian_bwd(const PreParams& p, int t, float4 q4,
                                               const float* s_dt, float* row, float* s_pw,
                                               float* s_sc, float* s_g) {
  constexpr int NB = ShRow<DEG>::NB, W = ShRow<DEG>::W;
  const float* cam = p.cam;
  const float r00 = cam[0], r01 = cam[1], r02 = cam[2];
  const float r10 = cam[3], r11 = cam[4], r12 = cam[5];
  const float r20 = cam[6], r21 = cam[7], r22 = cam[8];
  const float t0 = cam[9], t1 = cam[10], t2 = cam[11];
  const float w0 = cam[12], w1 = cam[13], w2 = cam[14];
  const float fx = cam[15], fy = cam[16];
  const float limx = cam[19], limy = cam[20];

  const float px = s_pw[3 * t], py = s_pw[3 * t + 1], pz = s_pw[3 * t + 2];
  const float sx = s_sc[3 * t], sy = s_sc[3 * t + 1], sz = s_sc[3 * t + 2];
  const float qw = q4.x, qx = q4.y, qy = q4.z, qz = q4.w;

  // cotangent of the live columns: ux uy | conic a b c | alpha | r g b
  const float4* ct = reinterpret_cast<const float4*>(s_dt + t * TABLE_COLS);
  const float4 ct0 = ct[0], ct1 = ct[1];
  const float gux = ct0.x, guy = ct0.y, gA = ct0.z, gB = ct0.w;
  const float gC = ct1.x;
  const float gcol[3] = {ct1.z, ct1.w, s_dt[t * TABLE_COLS + 8]};

  // ---- forward intermediates (csrc/preprocess.cu, `_forward_rows`) ----
  const float pcx = px * r00 + py * r01 + pz * r02 + t0;
  const float pcy = px * r10 + py * r11 + pz * r12 + t1;
  const float pcz = px * r20 + py * r21 + pz * r22 + t2;
  const bool in_front = pcz >= MIN_DEPTH;
  const float zsafe = in_front ? pcz : 1.0f;

  // R(q) and M = R diag(s): rows of M are the m_i*
  const float R[3][3] = {
      {1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qz * qw), 2.0f * (qx * qz + qy * qw)},
      {2.0f * (qx * qy + qz * qw), 1.0f - 2.0f * (qx * qx + qz * qz), 2.0f * (qy * qz - qx * qw)},
      {2.0f * (qx * qz - qy * qw), 2.0f * (qy * qz + qx * qw), 1.0f - 2.0f * (qx * qx + qy * qy)}};
  const float s[3] = {sx, sy, sz};
  float m[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) m[a][b] = R[a][b] * s[b];
  const float sxx = m[0][0] * m[0][0] + m[0][1] * m[0][1] + m[0][2] * m[0][2];
  const float sxy = m[0][0] * m[1][0] + m[0][1] * m[1][1] + m[0][2] * m[1][2];
  const float sxz = m[0][0] * m[2][0] + m[0][1] * m[2][1] + m[0][2] * m[2][2];
  const float syy = m[1][0] * m[1][0] + m[1][1] * m[1][1] + m[1][2] * m[1][2];
  const float syz = m[1][0] * m[2][0] + m[1][1] * m[2][1] + m[1][2] * m[2][2];
  const float szz = m[2][0] * m[2][0] + m[2][1] * m[2][1] + m[2][2] * m[2][2];

  const float tx = pcx / zsafe, ty = pcy / zsafe;
  const float ctx = fminf(fmaxf(tx, -limx), limx), cty = fminf(fmaxf(ty, -limy), limy);
  const float cxv = ctx * zsafe, cyv = cty * zsafe;
  const float z2 = zsafe * zsafe;
  const float jx0 = fx / zsafe, jx2 = -fx * cxv / z2;
  const float jy1 = fy / zsafe, jy2 = -fy * cyv / z2;
  const float a0 = jx0 * r00 + jx2 * r20, a1 = jx0 * r01 + jx2 * r21, a2 = jx0 * r02 + jx2 * r22;
  const float b0 = jy1 * r10 + jy2 * r20, b1 = jy1 * r11 + jy2 * r21, b2 = jy1 * r12 + jy2 * r22;
  const float sa0 = sxx * a0 + sxy * a1 + sxz * a2;
  const float sa1 = sxy * a0 + syy * a1 + syz * a2;
  const float sa2 = sxz * a0 + syz * a1 + szz * a2;
  const float sb0 = sxx * b0 + sxy * b1 + sxz * b2;
  const float sb1 = sxy * b0 + syy * b1 + syz * b2;
  const float sb2 = sxz * b0 + syz * b1 + szz * b2;
  const float ca = a0 * sa0 + a1 * sa1 + a2 * sa2 + 0.3f;
  const float cb = a0 * sb0 + a1 * sb1 + a2 * sb2;
  const float cc = b0 * sb0 + b1 * sb1 + b2 * sb2 + 0.3f;
  const float det = ca * cc - cb * cb;
  const bool det_ok = !(fabsf(det) < 1e-12f);
  const float det_inv = 1.0f / (det_ok ? det : 1e-12f);

  // ---- stage 4 backward: SH colour (A.4) ----
  // dY_k = sum_c sh[k,c] gcol[c] from the thread's shared row
  float dY[NB];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j4 = 0; j4 < W / 4; ++j4) {
      const float4 v = reinterpret_cast<const float4*>(row)[j4];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * j4 + u;
        dY[j / 3] = (j % 3 == 0 ? 0.0f : dY[j / 3]) + e[u] * gcol[j % 3];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) dY[j / 3] = (j % 3 == 0 ? 0.0f : dY[j / 3]) + row[j] * gcol[j % 3];
  }
  const float rx = px - w0, ry = py - w1, rz = pz - w2;
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  const float inv = 1.0f / fmaxf(norm, 1e-12f);
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;  // d loss / d (unit view direction)
  // each Y_k as it is formed: its gradient term, and Y_k into the row's
  // first NB floats (the row's SH values are all read) for the d_shs store
  sh_basis<DEG>(p.shc, Dual(rx * inv, 1.0f, 0.0f, 0.0f), Dual(ry * inv, 0.0f, 1.0f, 0.0f),
                Dual(rz * inv, 0.0f, 0.0f, 1.0f), [&](int k, const Dual& b) {
                  row[k] = b.v;
                  gdx += dY[k] * b.dx;
                  gdy += dY[k] * b.dy;
                  gdz += dY[k] * b.dz;
                });
  s_g[4 * t] = gcol[0];
  s_g[4 * t + 1] = gcol[1];
  s_g[4 * t + 2] = gcol[2];
  // direction = r * inv, inv = 1 / max(norm, 1e-12)
  float dpx = gdx * inv, dpy = gdy * inv, dpz = gdz * inv;
  if (norm >= 1e-12f) {
    const float d_norm = -(gdx * rx + gdy * ry + gdz * rz) * inv * inv;
    dpx += d_norm * rx / norm;
    dpy += d_norm * ry / norm;
    dpz += d_norm * rz / norm;
  }

  // ---- stage 5 backward: conic = (cc, -cb, ca) / det (A.5) ----
  float dca = gC * det_inv, dcb = -gB * det_inv, dcc = gA * det_inv;
  if (det_ok) {
    const float d_det = -(gA * cc - gB * cb + gC * ca) * det_inv * det_inv;
    dca += d_det * cc;
    dcc += d_det * ca;
    dcb -= 2.0f * cb * d_det;
  }

  // ---- stage 3 backward: ca = a'Sa + .3, cb = a'Sb, cc = b'Sb + .3 (A.3) ----
  const float da0 = 2.0f * dca * sa0 + dcb * sb0;
  const float da1 = 2.0f * dca * sa1 + dcb * sb1;
  const float da2 = 2.0f * dca * sa2 + dcb * sb2;
  const float db0 = 2.0f * dcc * sb0 + dcb * sa0;
  const float db1 = 2.0f * dcc * sb1 + dcb * sa1;
  const float db2 = 2.0f * dcc * sb2 + dcb * sa2;
  // dS = u a' + v b' with u = dca a, v = dcb a + dcc b, folded onto the six
  // unique entries of the symmetric S
  const float u0 = dca * a0, u1 = dca * a1, u2 = dca * a2;
  const float v0 = dcb * a0 + dcc * b0, v1 = dcb * a1 + dcc * b1, v2 = dcb * a2 + dcc * b2;
  const float dsxx = u0 * a0 + v0 * b0;
  const float dsxy = u0 * a1 + u1 * a0 + v0 * b1 + v1 * b0;
  const float dsxz = u0 * a2 + u2 * a0 + v0 * b2 + v2 * b0;
  const float dsyy = u1 * a1 + v1 * b1;
  const float dsyz = u1 * a2 + u2 * a1 + v1 * b2 + v2 * b1;
  const float dszz = u2 * a2 + v2 * b2;
  // a = J_x Rcw, b = J_y Rcw
  const float djx0 = da0 * r00 + da1 * r01 + da2 * r02;
  const float djx2 = da0 * r20 + da1 * r21 + da2 * r22;
  const float djy1 = db0 * r10 + db1 * r11 + db2 * r12;
  const float djy2 = db0 * r20 + db1 * r21 + db2 * r22;
  float dzsafe = -djx0 * jx0 / zsafe - djy1 * jy1 / zsafe;
  const float dz2 = -djx2 * jx2 / z2 - djy2 * jy2 / z2;
  dzsafe += 2.0f * zsafe * dz2;
  const float dcxv = -fx / z2 * djx2, dcyv = -fy / z2 * djy2;
  dzsafe += ctx * dcxv + cty * dcyv;
  const float dtx = (tx > -limx && tx < limx) ? zsafe * dcxv : 0.0f;
  const float dty = (ty > -limy && ty < limy) ? zsafe * dcyv : 0.0f;

  // ---- stage 1 backward: u = (pc_x fx / z + cx, pc_y fy / z + cy) (A.1) ----
  const float dpcx = gux * fx / zsafe + dtx / zsafe;
  const float dpcy = guy * fy / zsafe + dty / zsafe;
  dzsafe -= gux * (pcx * fx) / z2 + guy * (pcy * fy) / z2 + dtx * tx / zsafe + dty * ty / zsafe;
  const float dpcz = in_front ? dzsafe : 0.0f;
  dpx += r00 * dpcx + r10 * dpcy + r20 * dpcz;
  dpy += r01 * dpcx + r11 * dpcy + r21 * dpcz;
  dpz += r02 * dpcx + r12 * dpcy + r22 * dpcz;

  // ---- stage 2 backward: S = M M', M = R(q) diag(s) (A.2) ----
  const float dS[3][3] = {{2.0f * dsxx, dsxy, dsxz}, {dsxy, 2.0f * dsyy, dsyz},
                          {dsxz, dsyz, 2.0f * dszz}};
  float ds[3] = {0.0f, 0.0f, 0.0f};
  float dR[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float dm = dS[a][0] * m[0][b] + dS[a][1] * m[1][b] + dS[a][2] * m[2][b];
      ds[b] += dm * R[a][b];
      dR[a][b] = dm * s[b];
    }
  const float dqw = 2.0f * (-qz * dR[0][1] + qy * dR[0][2] + qz * dR[1][0] - qx * dR[1][2]
                            - qy * dR[2][0] + qx * dR[2][1]);
  const float dqx = 2.0f * (qy * dR[0][1] + qz * dR[0][2] + qy * dR[1][0] - 2.0f * qx * dR[1][1]
                            - qw * dR[1][2] + qz * dR[2][0] + qw * dR[2][1]
                            - 2.0f * qx * dR[2][2]);
  const float dqy = 2.0f * (-2.0f * qy * dR[0][0] + qx * dR[0][1] + qw * dR[0][2]
                            + qx * dR[1][0] + qz * dR[1][2] - qw * dR[2][0] + qz * dR[2][1]
                            - 2.0f * qy * dR[2][2]);
  const float dqz = 2.0f * (-2.0f * qz * dR[0][0] - qw * dR[0][1] + qx * dR[0][2]
                            + qw * dR[1][0] - 2.0f * qz * dR[1][1] + qy * dR[1][2]
                            + qx * dR[2][0] + qy * dR[2][1]);

  s_pw[3 * t] = dpx;
  s_pw[3 * t + 1] = dpy;
  s_pw[3 * t + 2] = dpz;
  s_sc[3 * t] = ds[0];
  s_sc[3 * t + 1] = ds[1];
  s_sc[3 * t + 2] = ds[2];
  return make_float4(dqw, dqx, dqy, dqz);
}

template <int DEG>
__global__ void __launch_bounds__(B)
preprocess_bwd_kernel(const __grid_constant__ PreParams p, const float* __restrict__ pws,
                      const float* __restrict__ shs,
                      const float* __restrict__ scales,
                      const float* __restrict__ rots,
                      const float* __restrict__ dtable,
                      float* __restrict__ d_pws, float* __restrict__ d_shs,
                      float* __restrict__ d_alphas,
                      float* __restrict__ d_scales,
                      float* __restrict__ d_rots, int n) {
  constexpr int W = ShRow<DEG>::W, SW = ShRow<DEG>::SW;
  extern __shared__ float4 s_mem[];
  float* s_sh = reinterpret_cast<float*>(s_mem);  // [B][SW]: SH rows, then Y_k
  float* s_dt = s_sh + B * SW;                     // [B][TABLE_COLS]
  float* s_pw = s_dt + B * TABLE_COLS;             // [B][3]: pws, then d_pws
  float* s_sc = s_pw + B * 3;                      // [B][3]: scales, then d_scales
  float* s_g = s_sc + B * 3;                       // [B][4]: colour cotangents
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * B;
  const int nb = min(B, n - i0);
  const int i = i0 + t;
  stage<W, SW>(s_sh, shs + (size_t)i0 * W, nb * W);
  stage<TABLE_COLS, TABLE_COLS>(s_dt, dtable + (size_t)i0 * TABLE_COLS, nb * TABLE_COLS);
  stage<3, 3>(s_pw, pws + (size_t)i0 * 3, nb * 3);
  stage<3, 3>(s_sc, scales + (size_t)i0 * 3, nb * 3);
  cp_async_commit();
  const float4 q4 =
      t < nb ? reinterpret_cast<const float4*>(rots)[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  cp_async_wait<0>();
  __syncthreads();

  if (t < nb) {
    const float4 dq = gaussian_bwd<DEG>(p, t, q4, s_dt, s_sh + t * SW, s_pw, s_sc, s_g);
    d_alphas[i] = s_dt[t * TABLE_COLS + 5];  // alpha passes through: its cotangent
    reinterpret_cast<float4*>(d_rots)[i] = dq;
  }
  __syncthreads();

  unstage(d_pws + (size_t)i0 * 3, s_pw, nb * 3);
  unstage(d_scales + (size_t)i0 * 3, s_sc, nb * 3);
  // d_shs[g, 3k + c] = Y_k(g) gcol_c(g) over the block's flat slice
  float* dsh = d_shs + (size_t)i0 * W;
  const int count = nb * W;
  auto outer = [&](int q) {
    const int g = q / W, j = q % W;
    return s_sh[g * SW + j / 3] * s_g[4 * g + j % 3];
  };
  for (int e4 = t; e4 < count / 4; e4 += B) {
    const int e = 4 * e4;
    reinterpret_cast<float4*>(dsh)[e4] =
        make_float4(outer(e), outer(e + 1), outer(e + 2), outer(e + 3));
  }
  for (int q = (count & ~3) + t; q < count; q += B) dsh[q] = outer(q);
}

template <int DEG>
const void* kernel_of() {
  return reinterpret_cast<const void*>(preprocess_bwd_kernel<DEG>);
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

// Parameters as egs_preprocess_fwd takes them; dtable [N,12] float32 device;
// d_*: device outputs shaped like the parameters. Every array but alphas
// and d_alphas 16-byte aligned.
extern "C" int egs_preprocess_bwd(const float* pws, const float* shs,
                                  const float* alphas, const float* scales,
                                  const float* rots, const float* dtable,
                                  const float* cam_host, const float* shc_host,
                                  float* d_pws, float* d_shs, float* d_alphas,
                                  float* d_scales, float* d_rots, int n,
                                  int n_bases, void* stream) {
  (void)alphas;  // alpha passes through the table: its gradient is the cotangent
  PreParams p;
  memcpy(p.cam, cam_host, sizeof(p.cam));
  memcpy(p.shc, shc_host, sizeof(p.shc));
  const void* fn;
  size_t smem;
  if (!kernel_for(n_bases, &fn, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  if (!(aligned(pws, 16) && aligned(shs, 16) && aligned(scales, 16) && aligned(rots, 16) &&
        aligned(dtable, 16) && aligned(d_pws, 16) && aligned(d_shs, 16) &&
        aligned(d_scales, 16) && aligned(d_rots, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  void* args[] = {&p,     (void*)&pws,   (void*)&shs,      (void*)&scales, (void*)&rots,
                  (void*)&dtable, (void*)&d_pws, (void*)&d_shs, (void*)&d_alphas,
                  (void*)&d_scales, (void*)&d_rots, (void*)&n};
  cudaError_t e = cudaLaunchKernel(fn, dim3((n + B - 1) / B), dim3(B), args, smem,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the compiled K2 kernel for n_bases takes on the card, written to
// out[0..4]: registers a thread, shared bytes a block (static and dynamic),
// local (spill) bytes a thread, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and threads a block.
extern "C" int egs_preprocess_bwd_info(int n_bases, int* out) {
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
