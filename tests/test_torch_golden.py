"""PyTorch port: its copy of the float64 golden oracle
(easygaussiansplatting_tpu_torch/golden/) bit-equal to the JAX package's
(easygaussiansplatting_tpu/golden/): every stage, the tile lists, the render,
the 8 analytic Jacobians and numerical_derivative, on the 4-gaussian fixture
with degree-3 SH and on a random 64-gaussian scene. Both are numpy float64
with the same expressions, so nothing may differ by a single bit."""

import numpy as np
import pytest

from easygaussiansplatting_tpu import golden as jax_golden
from easygaussiansplatting_tpu.golden import analytic as jax_analytic
from easygaussiansplatting_tpu_torch import golden
from easygaussiansplatting_tpu_torch.data import example_camera, example_gaussians
from easygaussiansplatting_tpu_torch.golden import analytic, model


def _fixture():
    g = example_gaussians()
    rng = np.random.default_rng(0)
    shs = np.zeros((4, 48))
    shs[:, :3] = g["shs"]
    shs[:, 3:] = rng.normal(size=(4, 45)) * 0.05
    return {**g, "shs": shs}


def _random64():
    rng = np.random.default_rng(7)
    n = 64
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return {"pws": rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5]), "rots": rots,
            "scales": np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2),
            "alphas": 1 / (1 + np.exp(-rng.normal(size=n))),
            "shs": rng.normal(size=(n, 48)) * 0.3}


SCENES = {"fixture": _fixture, "random64": _random64}


def _stages(gm, g, c):
    """Every stage output of one scene through golden module ``gm``."""
    us, pcs, depths = gm.project(g["pws"], c["Rcw"], c["tcw"], c["fx"], c["fy"], c["cx"], c["cy"])
    cov3d = gm.compute_cov3d(g["rots"], g["scales"])
    cov2d = gm.compute_cov2d(cov3d, pcs, c["Rcw"], c["fx"], c["fy"], c["width"], c["height"])
    twc = -np.asarray(c["Rcw"]).T @ np.asarray(c["tcw"])
    colors = gm.sh2color(g["shs"], g["pws"], twc)
    cinv, areas = gm.inverse_cov2d(cov2d)
    return dict(us=us, pcs=pcs, depths=depths, cov3d=cov3d, cov2d=cov2d, twc=twc,
                colors=colors, cinv=cinv, areas=areas)


def _outputs(which, gm, am, g, c):
    s = _stages(gm, g, c)
    w, h = c["width"], c["height"]
    if which == "stages":
        return [s[k] for k in ("us", "pcs", "depths", "cov3d", "cov2d", "colors", "cinv", "areas")]
    if which == "tile_lists":
        rects, valid = gm.model.gaussian_rects(s["us"], s["areas"], s["depths"], w, h)
        lists, dims = gm.tile_lists(s["us"], s["areas"], s["depths"], w, h)
        return [rects, valid, np.asarray(dims)] + [lists[t] for t in sorted(lists)]
    if which == "render_tiles":
        return list(gm.render_tiles(s["us"], s["cinv"], g["alphas"], s["depths"], s["colors"],
                                    s["areas"], w, h))
    if which == "render":
        img, aux = gm.render(g["pws"], g["shs"], g["alphas"], g["scales"], g["rots"], c["Rcw"],
                             c["tcw"], c["fx"], c["fy"], c["cx"], c["cy"], w, h)
        return [img] + [aux[k] for k in sorted(aux)]
    if which == "analytic":
        return [*am.project_jacobians(g["pws"], c["Rcw"], c["tcw"], c["fx"], c["fy"]),
                *am.cov3d_jacobians(g["rots"], g["scales"]),
                *am.cov2d_jacobians(s["cov3d"], s["pcs"], c["Rcw"], c["fx"], c["fy"], w, h),
                *am.sh2color_jacobians(g["shs"], g["pws"], s["twc"]),
                am.conic_jacobians(s["cov2d"])]
    if which == "numerical_derivative":
        return [gm.numerical_derivative(lambda r: gm.compute_cov3d(r, g["scales"]),
                                        [g["rots"]], 0),
                gm.numerical_derivative(lambda p: gm.sh2color(g["shs"], p, s["twc"]),
                                        [g["pws"]], 0, delta=1e-6, central=False)]
    raise ValueError(which)


@pytest.mark.parametrize("which", ["stages", "tile_lists", "render_tiles", "render",
                                   "analytic", "numerical_derivative"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_port_golden_is_bit_equal_to_jax_golden(scene, which):
    g, c = SCENES[scene](), example_camera()
    got = _outputs(which, golden, analytic, g, c)
    want = _outputs(which, jax_golden, jax_analytic, g, c)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"{which} output {i}")
    if which == "analytic":
        assert len(got) == 9  # project (2), cov3d (2), cov2d (2), sh2color (2), conic


def test_fixture_renders_the_reference_blobs():
    """A sanity check of the copy on its own: the fixture lights pixels."""
    g, c = _fixture(), example_camera()
    img, aux = model.render(g["pws"], g["shs"], g["alphas"], g["scales"], g["rots"], c["Rcw"],
                            c["tcw"], c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"])
    assert img.shape == (3, 16, 32) and img.max() > 0.1
    assert int(aux["contrib"].max()) >= 1
