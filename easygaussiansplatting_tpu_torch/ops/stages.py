"""Stages 1-5 of the splatting pipeline as plain, batched PyTorch functions.

Port of easygaussiansplatting_tpu/ops/stages.py. This is the plain version of
kernel K1 (ops/kernels/preprocess.py, csrc/preprocess.cu) and the CPU path;
its autograd VJP is the plain version of kernel K2 (csrc/preprocess_bwd.cu).

Every expression is evaluated in float32 in the order the JAX fused
preprocess (``ops/pallas/preprocess.py::_forward_rows``) writes it: the short
dot products and the SH accumulation are explicit left-to-right sums, and the
view direction is scaled by a reciprocal norm. The CUDA kernel evaluates the
same chain with multiply-add contraction switched off, so the two agree to
the last bit wherever the device's division and square root are correctly
rounded. Camera values enter as float32 scalars.

All functions are total on padded pools: entries behind the camera
(depth < MIN_DEPTH) produce finite outputs and are masked by ``valid``. They
are differentiable and write nothing in place. The guards ``zsafe``,
``det_safe`` and ``max(norm, 1e-12)`` are ``where``/``clamp`` selections whose
discarded branch is finite, so they guard the gradient as they do in JAX:
an entry behind the camera or with a degenerate determinant gets exactly
zero from a zero cotangent, never NaN.
"""

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.utils.sh import DEGREE_OF_BASES, sh_basis

MIN_DEPTH = 0.2


def _f32(v):
    """A host scalar as the Python float holding its float32 value."""
    return float(np.float32(v))


def _rdiv(num, t):
    """``num / t`` for a Python scalar ``num``, as a true division (torch's
    ``scalar / tensor`` multiplies by a reciprocal, which rounds twice). The
    scalar is filled on the device: no host-to-device copy, no sync."""
    return torch.full((), num, dtype=t.dtype, device=t.device) / t


def fov_limit(size, f):
    """1.3 * tan(fov/2) along one axis, in float32 as the JAX package
    computes it: 1.3 * (size / (2 f))."""
    f32 = np.float32
    return float(f32(1.3) * (f32(size) / (f32(2.0) * f32(f))))


def project(pws, Rcw, tcw, fx, fy, cx, cy):
    """Stage 1: world -> camera -> pixel. Returns (us [N,2], pcs [N,3],
    depths [N])."""
    R = np.asarray(Rcw, np.float32)
    t = np.asarray(tcw, np.float32)
    pcs = torch.stack(
        [
            pws[:, 0] * _f32(R[c, 0]) + pws[:, 1] * _f32(R[c, 1])
            + pws[:, 2] * _f32(R[c, 2]) + _f32(t[c])
            for c in range(3)
        ],
        dim=1,
    )
    z = pcs[:, 2]
    zsafe = torch.where(z >= MIN_DEPTH, z, 1.0)
    us = torch.stack(
        [pcs[:, 0] * _f32(fx) / zsafe + _f32(cx),
         pcs[:, 1] * _f32(fy) / zsafe + _f32(cy)], dim=1
    )
    return us, pcs, z


def compute_cov3d(rots, scales):
    """Stage 2: unit quaternion (wxyz) + scales -> Sigma upper triangle [N,6]
    (xx, xy, xz, yy, yz, zz), Sigma = (R S)(R S)^T."""
    w, x, y, z = rots[:, 0], rots[:, 1], rots[:, 2], rots[:, 3]
    sx, sy, sz = scales[:, 0], scales[:, 1], scales[:, 2]
    m00 = (1 - 2 * (y * y + z * z)) * sx
    m01 = (2 * (x * y - z * w)) * sy
    m02 = (2 * (x * z + y * w)) * sz
    m10 = (2 * (x * y + z * w)) * sx
    m11 = (1 - 2 * (x * x + z * z)) * sy
    m12 = (2 * (y * z - x * w)) * sz
    m20 = (2 * (x * z - y * w)) * sx
    m21 = (2 * (y * z + x * w)) * sy
    m22 = (1 - 2 * (x * x + y * y)) * sz
    c_xx = m00 * m00 + m01 * m01 + m02 * m02
    c_xy = m00 * m10 + m01 * m11 + m02 * m12
    c_xz = m00 * m20 + m01 * m21 + m02 * m22
    c_yy = m10 * m10 + m11 * m11 + m12 * m12
    c_yz = m10 * m20 + m11 * m21 + m12 * m22
    c_zz = m20 * m20 + m21 * m21 + m22 * m22
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=1)


def compute_cov2d(cov3ds, pcs, Rcw, fx, fy, width, height):
    """Stage 3: EWA projection to 2D, M Sigma M^T + 0.3 I with M = J Rcw and
    x/z, y/z clamped to +-1.3 tan(fov) (:func:`fov_limit`). Returns [N,3]
    (a, b, c)."""
    limx, limy = fov_limit(width, fx), fov_limit(height, fy)
    R = np.asarray(Rcw, np.float32)
    r = [[_f32(R[i, j]) for j in range(3)] for i in range(3)]
    fx, fy = _f32(fx), _f32(fy)
    x, y, z = pcs[:, 0], pcs[:, 1], pcs[:, 2]
    zsafe = torch.where(z >= MIN_DEPTH, z, 1.0)
    cxv = torch.clamp(x / zsafe, -limx, limx) * zsafe
    cyv = torch.clamp(y / zsafe, -limy, limy) * zsafe
    z2 = zsafe * zsafe
    jx0 = _rdiv(fx, zsafe)
    jx2 = -fx * cxv / z2
    jy1 = _rdiv(fy, zsafe)
    jy2 = -fy * cyv / z2
    # rows of M = J @ Rcw
    a = [jx0 * r[0][j] + jx2 * r[2][j] for j in range(3)]
    b = [jy1 * r[1][j] + jy2 * r[2][j] for j in range(3)]
    sxx, sxy, sxz = cov3ds[:, 0], cov3ds[:, 1], cov3ds[:, 2]
    syy, syz, szz = cov3ds[:, 3], cov3ds[:, 4], cov3ds[:, 5]

    def sig_dot(v):  # Sigma @ v
        return (
            sxx * v[0] + sxy * v[1] + sxz * v[2],
            sxy * v[0] + syy * v[1] + syz * v[2],
            sxz * v[0] + syz * v[1] + szz * v[2],
        )

    sa = sig_dot(a)
    sb = sig_dot(b)
    ca = a[0] * sa[0] + a[1] * sa[1] + a[2] * sa[2] + 0.3
    cb = a[0] * sb[0] + a[1] * sb[1] + a[2] * sb[2]
    cc = b[0] * sb[0] + b[1] * sb[1] + b[2] * sb[2] + 0.3
    return torch.stack([ca, cb, cc], dim=1)


def sh_bases(width, degree):
    """The SH basis count of an [N, width] coefficient array, whose width
    must be 3*(deg+1)^2 with deg <= ``degree`` (an upper cap)."""
    n_bases = width // 3
    if width % 3 or n_bases not in DEGREE_OF_BASES:
        raise ValueError(f"shs width {width} is not 3*(deg+1)^2")
    if DEGREE_OF_BASES[n_bases] > degree:
        raise ValueError(f"shs width {width} exceeds sh_degree={degree}")
    return n_bases


def sh2color(shs, pws, twc, degree=3):
    """Stage 4: real SH -> RGB along the view ray.

    shs: [N, 3*n_bases], RGB interleaved per basis function; the basis count
    comes from the width (``degree`` is an upper cap), as in the JAX stages.
    """
    n_bases = sh_bases(shs.shape[1], degree)
    deg = DEGREE_OF_BASES[n_bases]
    w = np.asarray(twc, np.float32)
    rx = pws[:, 0] - _f32(w[0])
    ry = pws[:, 1] - _f32(w[1])
    rz = pws[:, 2] - _f32(w[2])
    norm = torch.sqrt(rx * rx + ry * ry + rz * rz)
    inv = _rdiv(1.0, torch.clamp(norm, min=1e-12))
    basis = sh_basis(torch, rx * inv, ry * inv, rz * inv, deg)
    cols = []
    for c in range(3):
        acc = basis[0] * shs[:, c]
        for k in range(1, n_bases):
            acc = acc + basis[k] * shs[:, 3 * k + c]
        cols.append(0.5 + acc)
    return torch.stack(cols, dim=1)


def inverse_cov2d(cov2ds):
    """Stage 5: conic (2x2 analytic inverse) + 3-sigma extents.

    Returns (cinv2ds [N,3], areas [N,2] float). Degenerate determinants are
    guarded; the rasteriser's alpha' threshold culls them.
    """
    a, b, c = cov2ds[:, 0], cov2ds[:, 1], cov2ds[:, 2]
    det = a * c - b * b
    det_safe = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    det_inv = _rdiv(1.0, det_safe)
    cinv = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=1)
    areas = torch.ceil(3.0 * torch.sqrt(torch.abs(torch.stack([a, c], dim=1))))
    return cinv, areas


def preprocess(pws, shs, alphas, scales, rots, cam, alive=None, sh_degree=3):
    """Run stages 1-5 for a camera. Returns a dict of per-Gaussian tensors plus
    the validity mask (depth cull + optional pool-alive mask)."""
    us, pcs, depths = project(pws, cam.Rcw, cam.tcw, cam.fx, cam.fy, cam.cx, cam.cy)
    cov3ds = compute_cov3d(rots, scales)
    cov2ds = compute_cov2d(cov3ds, pcs, cam.Rcw, cam.fx, cam.fy, cam.width, cam.height)
    colors = sh2color(shs, pws, cam.twc, degree=sh_degree)
    cinv2ds, areas = inverse_cov2d(cov2ds)
    valid = depths >= MIN_DEPTH
    if alive is not None:
        valid = valid & alive
    return {
        "us": us,
        "pcs": pcs,
        "depths": depths,
        "cov3ds": cov3ds,
        "cov2ds": cov2ds,
        "colors": colors,
        "cinv2ds": cinv2ds,
        "areas": areas,
        "alphas": alphas,
        "valid": valid,
    }
