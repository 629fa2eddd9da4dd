"""Numerical-differentiation verification harness.

Copy of easygaussiansplatting_tpu/golden/numdiff.py (see golden/model.py).
The central testing idea carried over from the reference's
backward_cpu.py:47-65: every analytic/autodiff gradient is checked against a
finite-difference Jacobian at abs tolerance 1e-4.
"""

import numpy as np


def numerical_derivative(func, args, arg_index, delta=1e-5, central=True):
    """Finite-difference Jacobian of func w.r.t. args[arg_index].

    func maps arrays to an array; returns J with shape
    (*out.shape, *args[arg_index].shape), flattened over both to 2D when both
    are 1D-able (matching the reference's [out_dim, in_dim] convention).
    """
    args = [np.asarray(a, dtype=np.float64) if isinstance(a, np.ndarray) else a for a in args]
    x = np.asarray(args[arg_index], dtype=np.float64)
    y0 = np.asarray(func(*args))
    out_dim = y0.size
    in_dim = x.size
    J = np.zeros((out_dim, in_dim))
    flat = x.reshape(-1)
    for j in range(in_dim):
        xp = flat.copy()
        xp[j] += delta
        args_p = list(args)
        args_p[arg_index] = xp.reshape(x.shape)
        yp = np.asarray(func(*args_p)).reshape(-1)
        if central:
            xm = flat.copy()
            xm[j] -= delta
            args_m = list(args)
            args_m[arg_index] = xm.reshape(x.shape)
            ym = np.asarray(func(*args_m)).reshape(-1)
            J[:, j] = (yp - ym) / (2.0 * delta)
        else:
            J[:, j] = (yp - y0.reshape(-1)) / delta
    return J


def check(a, b, atol=1e-4, name=""):
    """[OK]/[NG] allclose gate, reference backward_cpu.py:61-65 semantics.

    Returns True/False; prints a colored verdict like the reference scripts.
    """
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    ok = a.shape == b.shape and bool(np.all(np.abs(a - b) < atol))
    tag = "\033[92m[OK]\033[0m" if ok else "\033[91m[NG]\033[0m"
    if name:
        print(f"{tag} {name}")
    else:
        print(tag)
    return ok
