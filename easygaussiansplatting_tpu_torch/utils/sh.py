"""Real spherical-harmonics constants and basis, degrees 0..5.

Port of easygaussiansplatting_tpu/utils/sh.py. Each ``SH_Cn`` tuple holds the
2n+1 signed constants for degree n, ordered by m = -n..n, matching the
basis-polynomial order of :func:`sh_basis`. ``SH_CONSTS`` flattens them in
the same order for the CUDA preprocess kernel (csrc/preprocess.cu), which
takes its constants from here rather than spelling them out again.
"""

import math

SH_C0 = (0.5 * math.sqrt(1.0 / math.pi),)  # Y0,0

_c1 = math.sqrt(3.0 / (4.0 * math.pi))
SH_C1 = (-_c1, _c1, -_c1)  # Y1,-1  Y1,0  Y1,1

SH_C2 = (
    0.5 * math.sqrt(15.0 / math.pi),    # Y2,-2
    -0.5 * math.sqrt(15.0 / math.pi),   # Y2,-1
    0.25 * math.sqrt(5.0 / math.pi),    # Y2,0
    -0.5 * math.sqrt(15.0 / math.pi),   # Y2,1
    0.25 * math.sqrt(15.0 / math.pi),   # Y2,2
)

SH_C3 = (
    -0.25 * math.sqrt(35.0 / (2.0 * math.pi)),  # Y3,-3
    0.5 * math.sqrt(105.0 / math.pi),           # Y3,-2
    -0.25 * math.sqrt(21.0 / (2.0 * math.pi)),  # Y3,-1
    0.25 * math.sqrt(7.0 / math.pi),            # Y3,0
    -0.25 * math.sqrt(21.0 / (2.0 * math.pi)),  # Y3,1
    0.25 * math.sqrt(105.0 / math.pi),          # Y3,2
    -0.25 * math.sqrt(35.0 / (2.0 * math.pi)),  # Y3,3
)

SH_C4 = (
    0.75 * math.sqrt(35.0 / math.pi),           # Y4,-4
    -0.75 * math.sqrt(35.0 / (2.0 * math.pi)),  # Y4,-3
    0.75 * math.sqrt(5.0 / math.pi),            # Y4,-2
    -0.75 * math.sqrt(5.0 / (2.0 * math.pi)),   # Y4,-1
    (3.0 / 16.0) * math.sqrt(1.0 / math.pi),    # Y4,0
    -0.75 * math.sqrt(5.0 / (2.0 * math.pi)),   # Y4,1
    (3.0 / 8.0) * math.sqrt(5.0 / math.pi),     # Y4,2
    -0.75 * math.sqrt(35.0 / (2.0 * math.pi)),  # Y4,3
    (3.0 / 16.0) * math.sqrt(35.0 / math.pi),   # Y4,4
)

SH_C5 = (
    -(3.0 / 32.0) * math.sqrt(154.0 / math.pi),   # Y5,-5
    (3.0 / 4.0) * math.sqrt(385.0 / math.pi),     # Y5,-4
    -(1.0 / 32.0) * math.sqrt(770.0 / math.pi),   # Y5,-3
    (1.0 / 4.0) * math.sqrt(1155.0 / math.pi),    # Y5,-2
    -(1.0 / 16.0) * math.sqrt(165.0 / math.pi),   # Y5,-1
    (1.0 / 16.0) * math.sqrt(11.0 / math.pi),     # Y5,0
    -(1.0 / 16.0) * math.sqrt(165.0 / math.pi),   # Y5,1
    (1.0 / 8.0) * math.sqrt(1155.0 / math.pi),    # Y5,2
    -(1.0 / 32.0) * math.sqrt(770.0 / math.pi),   # Y5,3
    (3.0 / 16.0) * math.sqrt(385.0 / math.pi),    # Y5,4
    -(3.0 / 32.0) * math.sqrt(154.0 / math.pi),   # Y5,5
)

SH_CONSTS = SH_C0 + SH_C1 + SH_C2 + SH_C3 + SH_C4 + SH_C5  # 36, basis order

# basis count -> degree, for the widths sh2color accepts
DEGREE_OF_BASES = {1: 0, 4: 1, 9: 2, 16: 3, 25: 4, 36: 5}


def num_sh_bases(degree: int) -> int:
    """Number of SH basis functions for degrees 0..degree inclusive."""
    return (degree + 1) ** 2


def sh_basis(xp, x, y, z, degree: int):
    """Evaluate the real SH basis polynomials (degrees 0..degree) at unit
    directions (x, y, z).

    ``xp`` is the array namespace (torch or numpy); the expressions and their
    evaluation order are those of the JAX package, so float32 inputs give
    float32 results rounded at the same places. Returns a list of
    (degree+1)^2 arrays shaped like ``x``.
    """
    one = xp.ones_like(x)
    out = [SH_C0[0] * one]
    if degree == 0:
        return out
    out += [SH_C1[0] * y, SH_C1[1] * z, SH_C1[2] * x]
    if degree == 1:
        return out
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out += [
        SH_C2[0] * xy,
        SH_C2[1] * yz,
        SH_C2[2] * (2.0 * zz - xx - yy),
        SH_C2[3] * xz,
        SH_C2[4] * (xx - yy),
    ]
    if degree == 2:
        return out
    out += [
        SH_C3[0] * y * (3.0 * xx - yy),
        SH_C3[1] * xy * z,
        SH_C3[2] * y * (4.0 * zz - xx - yy),
        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        SH_C3[4] * x * (4.0 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3.0 * yy),
    ]
    if degree == 3:
        return out
    out += [
        SH_C4[0] * xy * (xx - yy),
        SH_C4[1] * yz * (3.0 * xx - yy),
        SH_C4[2] * xy * (7.0 * zz - 1.0),
        SH_C4[3] * yz * (7.0 * zz - 3.0),
        SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
        SH_C4[5] * xz * (7.0 * zz - 3.0),
        SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
        SH_C4[7] * xz * (xx - 3.0 * yy),
        SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
    ]
    if degree == 4:
        return out
    # degree-5 forms follow the reference SH demo's convention, including
    # its sign-flipped variants for m = -1, 0, 1
    zz2 = zz * zz
    out += [
        SH_C5[0] * y * (5.0 * xx * xx - 10.0 * xx * yy + yy * yy),
        SH_C5[1] * xy * z * (xx - yy),
        SH_C5[2] * y * (3.0 * xx - yy) * (9.0 * zz - 1.0),
        SH_C5[3] * xy * z * (3.0 * zz - 1.0),
        SH_C5[4] * y * (14.0 * zz - 21.0 * zz2 - 1.0),
        SH_C5[5] * z * (70.0 * zz - 63.0 * zz2 - 15.0),
        SH_C5[6] * x * (14.0 * zz - 21.0 * zz2 - 1.0),
        SH_C5[7] * z * (xx - yy) * (3.0 * zz - 1.0),
        SH_C5[8] * x * (xx - 3.0 * yy) * (9.0 * zz - 1.0),
        SH_C5[9] * z * (xx * xx - 6.0 * xx * yy + yy * yy),
        SH_C5[10] * x * (xx * xx - 10.0 * xx * yy + 5.0 * yy * yy),
    ]
    return out


class _Dual:
    """A value and its gradient along (x, y, z), for forward-mode
    differentiation of the basis polynomials; csrc/preprocess_bwd.cu
    differentiates them the same way."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    @staticmethod
    def lift(o):
        return o if isinstance(o, _Dual) else _Dual(o, (0.0, 0.0, 0.0))

    def __add__(self, o):
        o = _Dual.lift(o)
        return _Dual(self.v + o.v, tuple(a + b for a, b in zip(self.d, o.d)))

    __radd__ = __add__

    def __sub__(self, o):
        o = _Dual.lift(o)
        return _Dual(self.v - o.v, tuple(a - b for a, b in zip(self.d, o.d)))

    def __rsub__(self, o):
        return _Dual.lift(o) - self

    def __mul__(self, o):
        o = _Dual.lift(o)
        return _Dual(self.v * o.v, tuple(self.v * b + a * o.v for a, b in zip(self.d, o.d)))

    __rmul__ = __mul__


def sh_basis_grad(xp, x, y, z, degree: int):
    """Gradients of the basis polynomials of degrees 0..degree (up to 5)
    with respect to the direction components: a list of (dY/dx, dY/dy,
    dY/dz) triples in :func:`sh_basis` order, each shaped like ``x``."""

    class _NS:
        @staticmethod
        def ones_like(d):
            return _Dual(xp.ones_like(d.v), (0.0, 0.0, 0.0))

    zero = xp.zeros_like(x)
    basis = sh_basis(_NS, _Dual(x, (1.0, 0.0, 0.0)), _Dual(y, (0.0, 1.0, 0.0)),
                     _Dual(z, (0.0, 0.0, 1.0)), degree)
    return [tuple(zero + g for g in b.d) for b in basis]
