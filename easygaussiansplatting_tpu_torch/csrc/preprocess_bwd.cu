// K2: VJP of the fused preprocess — stages 1-5 backward for one camera.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/preprocess.py
// `_bwd_kernel` (reached through `_bwd_call` and `_fused_bwd`), which runs
// jax.vjp of `_forward_rows` inside the kernel. Plain version: the autograd
// VJP of ops/stages.py (ops/kernels/preprocess.py::preprocess_bwd_plain).
//
// Design: one thread per gaussian recomputes the forward intermediates of
// `_forward_rows` and applies their transposes, derived by hand
// (docs/backward.md A.1-A.5): conic inverse, EWA covariance with the FoV
// clamp, projection, the quaternion-scale covariance, and the SH colour with
// its view-direction term. The SH basis is differentiated forward-mode
// (a value carried with its three partials), so every degree K1 supports
// (0-5) has its gradient without a second table of polynomials. Only the
// nine live table columns (u, conic, alpha, rgb) carry a cotangent: depth
// and the extents feed binning and the visibility mask, which take none.
// The camera takes no gradient, by contract.
//
// Guards, as autodiff of the forward has them: the clamp of x/z and y/z to
// +-1.3 tan(fov) passes no gradient outside it; a determinant below 1e-12
// (replaced by 1e-12) passes none to the covariance; a gaussian behind the
// camera uses z = 1 and passes none to its depth; the view-ray norm below
// 1e-12 passes none to the norm. Every discarded branch is finite, so a zero
// cotangent gives exactly zero, never NaN.
//
// What bounds it on an H100: bytes. Per gaussian it reads 4*(11 + S)
// parameter bytes and a 48-byte cotangent row and writes 4*(11 + S) gradient
// bytes (S = 48 at SH degree 3: 520 B), against some 600 FP32 operations:
// at N = 65,536 that is ~34 MB, ~0.010 ms at 3.35 TB/s. The camera and the SH
// constants ride in the by-value kernel parameters, and the degree is a
// template parameter so the basis stays in registers.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int TABLE_COLS = 12;
constexpr float MIN_DEPTH = 0.2f;

struct PreParams {
  float cam[21];  // Rcw (9, row-major) tcw (3) twc (3) fx fy cx cy limx limy
  float shc[36];  // SH constants in basis order (utils/sh.py SH_CONSTS)
};

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

// Real SH basis, degrees 0..DEG, as utils/sh.py sh_basis writes it (and
// csrc/preprocess.cu evaluates it), here over Dual values.
template <int DEG>
__device__ __forceinline__ void sh_basis(const float* c, Dual x, Dual y, Dual z, Dual* b) {
  b[0] = Dual(c[0]);
  if constexpr (DEG >= 1) {
    b[1] = c[1] * y;
    b[2] = c[2] * z;
    b[3] = c[3] * x;
  }
  if constexpr (DEG >= 2) {
    const Dual xx = x * x, yy = y * y, zz = z * z;
    const Dual xy = x * y, yz = y * z, xz = x * z;
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
      const Dual zz2 = zz * zz;
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
preprocess_bwd_kernel(PreParams p, const float* __restrict__ pws,
                      const float* __restrict__ shs,
                      const float* __restrict__ alphas,
                      const float* __restrict__ scales,
                      const float* __restrict__ rots,
                      const float* __restrict__ dtable,
                      float* __restrict__ d_pws, float* __restrict__ d_shs,
                      float* __restrict__ d_alphas,
                      float* __restrict__ d_scales,
                      float* __restrict__ d_rots, int n) {
  constexpr int NB = (DEG + 1) * (DEG + 1);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* cam = p.cam;
  const float r00 = cam[0], r01 = cam[1], r02 = cam[2];
  const float r10 = cam[3], r11 = cam[4], r12 = cam[5];
  const float r20 = cam[6], r21 = cam[7], r22 = cam[8];
  const float t0 = cam[9], t1 = cam[10], t2 = cam[11];
  const float w0 = cam[12], w1 = cam[13], w2 = cam[14];
  const float fx = cam[15], fy = cam[16];
  const float limx = cam[19], limy = cam[20];

  const float px = pws[3 * i], py = pws[3 * i + 1], pz = pws[3 * i + 2];
  const float sx = scales[3 * i], sy = scales[3 * i + 1], sz = scales[3 * i + 2];
  const float qw = rots[4 * i], qx = rots[4 * i + 1];
  const float qy = rots[4 * i + 2], qz = rots[4 * i + 3];

  // cotangent of the live columns: ux uy | conic a b c | alpha | r g b
  const float4* ct = reinterpret_cast<const float4*>(dtable + (size_t)i * TABLE_COLS);
  const float4 ct0 = ct[0], ct1 = ct[1];
  const float gux = ct0.x, guy = ct0.y, gA = ct0.z, gB = ct0.w;
  const float gC = ct1.x, galpha = ct1.y;
  const float gcol[3] = {ct1.z, ct1.w, dtable[(size_t)i * TABLE_COLS + 8]};

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
  const float rx = px - w0, ry = py - w1, rz = pz - w2;
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  const float inv = 1.0f / fmaxf(norm, 1e-12f);
  Dual basis[NB];
  sh_basis<DEG>(p.shc, Dual(rx * inv, 1.0f, 0.0f, 0.0f), Dual(ry * inv, 0.0f, 1.0f, 0.0f),
                Dual(rz * inv, 0.0f, 0.0f, 1.0f), basis);
  const float* sh = shs + (size_t)i * (3 * NB);
  float* dsh = d_shs + (size_t)i * (3 * NB);
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;  // d loss / d (unit view direction)
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float dY = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dsh[3 * k + c] = basis[k].v * gcol[c];
      dY += sh[3 * k + c] * gcol[c];
    }
    gdx += dY * basis[k].dx;
    gdy += dY * basis[k].dy;
    gdz += dY * basis[k].dz;
  }
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

  d_pws[3 * i] = dpx;
  d_pws[3 * i + 1] = dpy;
  d_pws[3 * i + 2] = dpz;
  d_alphas[i] = galpha;
  d_scales[3 * i] = ds[0];
  d_scales[3 * i + 1] = ds[1];
  d_scales[3 * i + 2] = ds[2];
  d_rots[4 * i] = dqw;
  d_rots[4 * i + 1] = dqx;
  d_rots[4 * i + 2] = dqy;
  d_rots[4 * i + 3] = dqz;
}

}  // namespace

// Parameters as egs_preprocess_fwd takes them; dtable [N,12] float32 device,
// 16-byte aligned; d_*: device outputs shaped like the parameters.
extern "C" int egs_preprocess_bwd(const float* pws, const float* shs,
                                  const float* alphas, const float* scales,
                                  const float* rots, const float* dtable,
                                  const float* cam_host, const float* shc_host,
                                  float* d_pws, float* d_shs, float* d_alphas,
                                  float* d_scales, float* d_rots, int n,
                                  int n_bases, void* stream) {
  PreParams p;
  memcpy(p.cam, cam_host, sizeof(p.cam));
  memcpy(p.shc, shc_host, sizeof(p.shc));
  if (n <= 0) return 0;
  const dim3 block(256), grid((n + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EGS_BWD_LAUNCH(D)                                                        \
  preprocess_bwd_kernel<D><<<grid, block, 0, st>>>(p, pws, shs, alphas, scales, \
                                                   rots, dtable, d_pws, d_shs,  \
                                                   d_alphas, d_scales, d_rots, n)
  switch (n_bases) {
    case 1: EGS_BWD_LAUNCH(0); break;
    case 4: EGS_BWD_LAUNCH(1); break;
    case 9: EGS_BWD_LAUNCH(2); break;
    case 16: EGS_BWD_LAUNCH(3); break;
    case 25: EGS_BWD_LAUNCH(4); break;
    case 36: EGS_BWD_LAUNCH(5); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EGS_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
