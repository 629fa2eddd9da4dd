"""Canonical smoke-test fixtures.

Port of easygaussiansplatting_tpu/data/fixtures.py (numpy on both sides, so
the arrays are bit-equal): the reference's 4-Gaussian scene and its 32x16
test camera.
"""

import numpy as np


def example_gaussians(dtype=np.float64):
    """Four axis-aligned Gaussians at the origin and unit points.

    Returns dict with pws [4,3], rots [4,4] (wxyz), scales [4,3], alphas [4],
    shs [4,3] (degree-0 RGB coefficients only).
    """
    c = 1.772484  # +-0.5 / SH_C0 in the reference fixture
    pws = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=dtype)
    rots = np.array([[1, 0, 0, 0]] * 4, dtype=dtype)
    scales = np.array(
        [[0.05, 0.05, 0.05], [0.2, 0.05, 0.05], [0.05, 0.2, 0.05], [0.05, 0.05, 0.2]],
        dtype=dtype,
    )
    alphas = np.ones(4, dtype=dtype)
    shs = np.array(
        [[c, -c, c], [c, -c, -c], [-c, c, -c], [-c, -c, c]],
        dtype=dtype,
    )
    return {"pws": pws, "rots": rots, "scales": scales, "alphas": alphas, "shs": shs}


def example_camera(dtype=np.float64):
    """The fixed 32x16 test camera of the verification harness."""
    tcw = np.array([1.03796196, 0.42017467, 4.67804612], dtype=dtype)
    Rcw = np.array(
        [
            [0.89699204, 0.06525223, 0.43720409],
            [-0.04508268, 0.99739184, -0.05636552],
            [-0.43974177, 0.03084909, 0.89759429],
        ],
        dtype=dtype,
    ).T
    width, height = 32, 16
    fx = fy = 16.0
    cx, cy = width / 2.0, height / 2.0
    return {
        "Rcw": Rcw,
        "tcw": tcw,
        "width": width,
        "height": height,
        "fx": fx,
        "fy": fy,
        "cx": cx,
        "cy": cy,
    }
