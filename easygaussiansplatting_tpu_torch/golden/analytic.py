"""Hand-derived analytic Jacobians for pipeline stages 1-5 (float64 numpy).

Copy of easygaussiansplatting_tpu/golden/analytic.py (see golden/model.py).
The third, derivation-independent gradient implementation: the gradient gate
(verify_gradients.py) checks autodiff against numerical differentiation;
this module closes the triangle the way the reference does with its
hand-derived per-stage Jacobians (backward_cpu.py:68-499). Every formula
below is derived by hand from the forward equations (docs/forward.md
F.1-F.5; derivations mirrored in docs/backward.md Appendix A) and checked
against float64 finite differences of the golden model.

Shapes follow the golden model's batch convention: a leading N axis,
Jacobians as [N, out_dims..., in_dims...].
"""

import numpy as np

from easygaussiansplatting_tpu_torch.utils.sh import SH_C1, SH_C2, SH_C3, sh_basis

_IU = np.triu_indices(3)  # upper-triangle order (xx, xy, xz, yy, yz, zz)


def project_jacobians(pws, Rcw, tcw, fx, fy):
    """Stage 1 (F.1): du/dpws [N,2,3] and ddepth/dpws [N,3].

    u = Jp(p_c) with p_c = Rcw pws + tcw, so du/dpws = Jp @ Rcw with the
    pinhole Jacobian Jp = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
    (F.3.4); depth = p_c[2], so ddepth/dpws = Rcw[2].
    """
    Rcw = np.asarray(Rcw, np.float64)
    pcs = pws @ Rcw.T + np.asarray(tcw, np.float64)
    x, y, z = pcs[:, 0], pcs[:, 1], pcs[:, 2]
    n = pws.shape[0]
    Jp = np.zeros((n, 2, 3))
    Jp[:, 0, 0] = fx / z
    Jp[:, 0, 2] = -fx * x / (z * z)
    Jp[:, 1, 1] = fy / z
    Jp[:, 1, 2] = -fy * y / (z * z)
    du = Jp @ Rcw[None]
    ddepth = np.broadcast_to(Rcw[2], (n, 3)).copy()
    return du, ddepth


def _dR_dq(rots):
    """dR/dq of the unit-quaternion rotation matrix (F.2.2): [N,4,3,3],
    ordered (w, x, y, z). Derived by differentiating each matrix entry's
    quadratic form; no normalisation chain (inputs are unit quaternions,
    matching compute_cov3d's contract)."""
    w, x, y, z = rots[:, 0], rots[:, 1], rots[:, 2], rots[:, 3]
    n = rots.shape[0]
    d = np.zeros((n, 4, 3, 3))
    zero = np.zeros(n)
    # dR/dw = 2 [[0,-z,y],[z,0,-x],[-y,x,0]]
    d[:, 0] = 2.0 * np.stack([
        np.stack([zero, -z, y], -1),
        np.stack([z, zero, -x], -1),
        np.stack([-y, x, zero], -1),
    ], 1)
    # dR/dx = 2 [[0,y,z],[y,-2x,-w],[z,w,-2x]]
    d[:, 1] = 2.0 * np.stack([
        np.stack([zero, y, z], -1),
        np.stack([y, -2 * x, -w], -1),
        np.stack([z, w, -2 * x], -1),
    ], 1)
    # dR/dy = 2 [[-2y,x,w],[x,0,z],[-w,z,-2y]]
    d[:, 2] = 2.0 * np.stack([
        np.stack([-2 * y, x, w], -1),
        np.stack([x, zero, z], -1),
        np.stack([-w, z, -2 * y], -1),
    ], 1)
    # dR/dz = 2 [[-2z,-w,x],[w,-2z,y],[x,y,0]]
    d[:, 3] = 2.0 * np.stack([
        np.stack([-2 * z, -w, x], -1),
        np.stack([w, -2 * z, y], -1),
        np.stack([x, y, zero], -1),
    ], 1)
    return d


def _rot_matrix(rots):
    w, x, y, z = rots[:, 0], rots[:, 1], rots[:, 2], rots[:, 3]
    R = np.empty((rots.shape[0], 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def cov3d_jacobians(rots, scales):
    """Stage 2 (F.2): dSigma/drots [N,6,4] and dSigma/dscales [N,6,3].

    Sigma = sum_j s_j^2 R_j R_j^T over the rotation columns R_j, so
    dSigma/ds_j = 2 s_j R_j R_j^T and dSigma/dq_k = dM M^T + M dM^T with
    M = R diag(s), dM = (dR/dq_k) diag(s).
    """
    R = _rot_matrix(rots)
    dR = _dR_dq(rots)
    M = R * scales[:, None, :]
    n = rots.shape[0]
    dq = np.zeros((n, 6, 4))
    for k in range(4):
        dM = dR[:, k] * scales[:, None, :]
        dS = dM @ M.transpose(0, 2, 1)
        dS = dS + dS.transpose(0, 2, 1)
        dq[:, :, k] = dS[:, _IU[0], _IU[1]]
    ds = np.zeros((n, 6, 3))
    for j in range(3):
        outer = R[:, :, j, None] * R[:, None, :, j]  # R_j R_j^T
        dS = 2.0 * scales[:, j, None, None] * outer
        ds[:, :, j] = dS[:, _IU[0], _IU[1]]
    return dq, ds


def cov2d_jacobians(cov3ds, pcs, Rcw, fx, fy, width, height):
    """Stage 3 (F.3): dcov2d/dcov3d [N,3,6] and dcov2d/dpcs [N,3,3].

    cov2d = uppertri(M' Sigma M'^T) + 0.3 I with M' = Jp Rcw evaluated at
    the FoV-clamped ratios (F.3.4-F.3.5). Sigma enters bilinearly:
    dSp_ab/dSigma_kl = m_a[k] m_b[l] (+ the symmetric term for k != l).
    p_c enters through Jp; the clamp's derivative is 0 on the clamped
    branch and shifts x~'s z-dependence onto the clamp value (see dxt_dz).
    """
    Rcw = np.asarray(Rcw, np.float64)
    n = cov3ds.shape[0]
    x, y, z = pcs[:, 0], pcs[:, 1], pcs[:, 2]
    lim_x = 1.3 * width / (2.0 * fx)
    lim_y = 1.3 * height / (2.0 * fy)
    rx, ry = x / z, y / z
    in_x = (np.abs(rx) <= lim_x).astype(np.float64)  # clamp-inactive mask
    in_y = (np.abs(ry) <= lim_y).astype(np.float64)
    xt = np.clip(rx, -lim_x, lim_x) * z
    yt = np.clip(ry, -lim_y, lim_y) * z
    # x~ = clip(x/z) z: dx~/dx = 1 [unclamped] else 0; dx~/dz = 0
    # [unclamped] else x~/z (the clamp value rides with z)
    dxt_dx = in_x
    dxt_dz = (1.0 - in_x) * xt / z
    dyt_dy = in_y
    dyt_dz = (1.0 - in_y) * yt / z

    def jp(xt, yt, z):
        J = np.zeros((n, 2, 3))
        J[:, 0, 0] = fx / z
        J[:, 0, 2] = -fx * xt / (z * z)
        J[:, 1, 1] = fy / z
        J[:, 1, 2] = -fy * yt / (z * z)
        return J

    Mp = jp(xt, yt, z) @ Rcw[None]  # [N,2,3]
    Sigma = np.zeros((n, 3, 3))
    Sigma[:, _IU[0], _IU[1]] = cov3ds
    Sigma[:, _IU[1], _IU[0]] = cov3ds

    # d/dSigma: Sp_ab = m_a . Sigma m_b
    dcov_dsig = np.zeros((n, 3, 6))
    pairs = ((0, 0), (0, 1), (1, 1))  # outputs (a, b, c)
    for o, (ai, bi) in enumerate(pairs):
        ma, mb = Mp[:, ai], Mp[:, bi]
        for t, (k, l) in enumerate(zip(*_IU)):
            v = ma[:, k] * mb[:, l]
            if k != l:
                v = v + ma[:, l] * mb[:, k]
            dcov_dsig[:, o, t] = v
    # d/dpcs through Jp
    dJ = np.zeros((n, 3, 2, 3))  # [N, dpc-axis, 2, 3]
    z2 = z * z
    dJ[:, 0, 0, 2] = -fx * dxt_dx / z2               # d/dx
    dJ[:, 1, 1, 2] = -fy * dyt_dy / z2               # d/dy
    dJ[:, 2, 0, 0] = -fx / z2                        # d/dz
    dJ[:, 2, 0, 2] = -fx * dxt_dz / z2 + 2 * fx * xt / (z2 * z)
    dJ[:, 2, 1, 1] = -fy / z2
    dJ[:, 2, 1, 2] = -fy * dyt_dz / z2 + 2 * fy * yt / (z2 * z)
    dcov_dpc = np.zeros((n, 3, 3))
    for i in range(3):
        dMp = dJ[:, i] @ Rcw[None]
        dSp = dMp @ Sigma @ Mp.transpose(0, 2, 1)
        dSp = dSp + dSp.transpose(0, 2, 1)
        dcov_dpc[:, 0, i] = dSp[:, 0, 0]
        dcov_dpc[:, 1, i] = dSp[:, 0, 1]
        dcov_dpc[:, 2, i] = dSp[:, 1, 1]
    return dcov_dsig, dcov_dpc


def sh2color_jacobians(shs, pws, twc, degree=None):
    """Stage 4 (F.4): dcolor/dshs [N,3,3K] and dcolor/dpws [N,3,3].

    Color is linear in the coefficients — dcolor_c/dsh_{k,c'} is the basis
    value Y_k times the channel delta. Through the position: with
    v = pws - twc, r = v/|v|, dr/dv = (I - r r^T)/|v| and
    dcolor/dpws = sum_k sh_k grad_r(Y_k) dr/dv.
    """
    n_bases = shs.shape[1] // 3
    if degree is None:
        degree = int(np.sqrt(n_bases)) - 1
    n = pws.shape[0]
    v = pws - np.asarray(twc, np.float64)
    norm = np.linalg.norm(v, axis=1, keepdims=True)
    r = v / norm
    basis = sh_basis(np, r[:, 0], r[:, 1], r[:, 2], degree)
    dshs = np.zeros((n, 3, 3 * n_bases))
    for k in range(n_bases):
        for c in range(3):
            dshs[:, c, 3 * k + c] = basis[k]
    grads = sh_basis_grad(np, r[:, 0], r[:, 1], r[:, 2], degree)
    drdp = (np.eye(3)[None] - r[:, :, None] * r[:, None, :]) / norm[:, :, None]
    dpws = np.zeros((n, 3, 3))
    for k in range(n_bases):
        gk = np.stack(grads[k], axis=1)  # [N,3] dY_k/dr
        contrib = np.einsum("nd,ndi->ni", gk, drdp)  # [N,3] dY_k/dpws
        dpws += shs[:, 3 * k : 3 * k + 3, None] * contrib[:, None, :]
    return dshs, dpws


def conic_jacobians(cov2ds):
    """Stage 5 (F.5.1): dconic/dcov2d [N,3,3] via d(S^-1) = -S^-1 dS S^-1
    over the three symmetric basis perturbations of (a, b, c)."""
    a, b, c = cov2ds[:, 0], cov2ds[:, 1], cov2ds[:, 2]
    det = a * c - b * b
    n = cov2ds.shape[0]
    Sinv = np.empty((n, 2, 2))
    Sinv[:, 0, 0] = c / det
    Sinv[:, 0, 1] = -b / det
    Sinv[:, 1, 0] = -b / det
    Sinv[:, 1, 1] = a / det
    bases = (
        np.array([[1.0, 0.0], [0.0, 0.0]]),
        np.array([[0.0, 1.0], [1.0, 0.0]]),
        np.array([[0.0, 0.0], [0.0, 1.0]]),
    )
    out = np.zeros((n, 3, 3))
    for i, E in enumerate(bases):
        dSinv = -Sinv @ E[None] @ Sinv
        out[:, 0, i] = dSinv[:, 0, 0]
        out[:, 1, i] = dSinv[:, 0, 1]
        out[:, 2, i] = dSinv[:, 1, 1]
    return out


def sh_basis_grad(xp, x, y, z, degree: int):
    """Hand-derived gradients of the degree-0..3 basis polynomials with
    respect to the direction components, in :func:`sh_basis` order: the JAX
    package's ``utils.sh.sh_basis_grad``, kept here with its expressions (the
    port's utils/sh.py differentiates by dual numbers, which rounds at other
    places)."""
    if degree > 3:
        raise NotImplementedError("analytic SH gradients cover degrees <= 3")
    zero = xp.zeros_like(x)
    out = [(zero, zero, zero)]  # Y0,0 constant
    if degree >= 1:
        c = SH_C1
        one = xp.ones_like(x)
        out += [
            (zero, c[0] * one, zero),          # c*y
            (zero, zero, c[1] * one),          # c*z
            (c[2] * one, zero, zero),          # c*x
        ]
    if degree >= 2:
        c = SH_C2
        out += [
            (c[0] * y, c[0] * x, zero),                        # xy
            (zero, c[1] * z, c[1] * y),                        # yz
            (-2 * c[2] * x, -2 * c[2] * y, 4 * c[2] * z),      # 2z^2-x^2-y^2
            (c[3] * z, zero, c[3] * x),                        # xz
            (2 * c[4] * x, -2 * c[4] * y, zero),               # x^2-y^2
        ]
    if degree >= 3:
        c = SH_C3
        xx, yy, zz = x * x, y * y, z * z
        out += [
            (c[0] * 6 * x * y, c[0] * (3 * xx - 3 * yy), zero),
            (c[1] * y * z, c[1] * x * z, c[1] * x * y),
            (c[2] * (-2 * x * y), c[2] * (4 * zz - xx - 3 * yy),
             c[2] * 8 * y * z),
            (c[3] * (-6 * x * z), c[3] * (-6 * y * z),
             c[3] * (6 * zz - 3 * xx - 3 * yy)),
            (c[4] * (4 * zz - 3 * xx - yy), c[4] * (-2 * x * y),
             c[4] * 8 * x * z),
            (c[5] * 2 * x * z, c[5] * (-2 * y * z), c[5] * (xx - yy)),
            (c[6] * (3 * xx - 3 * yy), c[6] * (-6 * x * y), zero),
        ]
    return out
