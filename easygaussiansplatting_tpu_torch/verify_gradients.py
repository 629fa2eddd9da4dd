"""Numerical-differentiation verification of the whole differentiable pipeline.

Port of the repository's root verify_gradients.py, run as

    python -m easygaussiansplatting_tpu_torch.verify_gradients [--device cpu]

On the canonical 4-Gaussian / 32x16 fixture with degree-3 SH it checks,
printing [OK]/[NG] at abs tol 1e-4, in the JAX gate's order:

 1. stage primal parity: the port's stages 1-5 (ops/stages.py) vs the float64
    golden model (the port's copy, golden/);
 2. stage gradients: autograd VJPs of the stages vs finite differences of the
    golden stage functions (random fixed cotangents);
 2b. the 8 hand-derived analytic Jacobians (golden/analytic.py) vs
    finite differences;
 3. rendered-image parity: the "tiled" and "cuda" backends vs the golden
    tile render;
 4. end-to-end parameter gradients: d(L1 loss)/d{pws, shs, alphas, scales,
    rots} by autograd vs finite differences through the full golden
    renderer, on "tiled" at 1e-4 and on "cuda" (the kernels K1, K2, K4, K5,
    K6) at max(1e-4, 1.5e-3 max|num|);
 5. the gradient reduce (sort, K6 and gathers) vs np.add.at at M = 131,072
    patches over 4,096 gaussians, past K6's block length, at 2e-4.

36 checks on a CUDA device. With ``--device cpu`` the 7 checks that need the
card (the "cuda" image, its five gradients and section 5) do not run: the
gate says so in one line and runs the other 29. Exit code 0 iff every check
that ran is [OK], and on a CUDA device all 36 ran.
"""

import argparse
import sys

import numpy as np
import torch

from easygaussiansplatting_tpu_torch import golden
from easygaussiansplatting_tpu_torch.data import example_camera, example_gaussians
from easygaussiansplatting_tpu_torch.golden import analytic
from easygaussiansplatting_tpu_torch.golden.numdiff import numerical_derivative
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import LIVE_COLS
from easygaussiansplatting_tpu_torch.ops.kernels.rasterize import sort_reduce_grads
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.utils.device import resolve_device

N_CHECKS = 36
CARD_CHECKS = ("render image (cuda)", "dloss/d{pws,shs,alphas,scales,rots} (cuda)",
               "sort-reduce vs scatter @ M=131072 (multi-block)")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if not on_card:
        print(f"not run on device {dev}: {', '.join(CARD_CHECKS)} -- 7 checks that need a "
              f"CUDA device (the kernels); running the other {N_CHECKS - 7}")

    ran = [0]

    def check(a, b, **kw):
        ran[0] += 1
        return golden.check(_np(a), _np(b), **kw)

    rng = np.random.default_rng(0)
    g = example_gaussians()
    c = example_camera()
    cam = Camera.from_dict(c)
    n = g["pws"].shape[0]
    # degree-3 SH like the reference harness (backward_cpu.py:503-527)
    shs = np.zeros((n, 48))
    shs[:, :3] = g["shs"]
    shs[:, 3:] = rng.normal(size=(n, 45)) * 0.05

    ok = True

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    # ---- 1. stage primal parity -------------------------------------------
    us_g, pcs_g, depths_g = golden.project(
        g["pws"], c["Rcw"], c["tcw"], c["fx"], c["fy"], c["cx"], c["cy"]
    )
    us_t, pcs_t, depths_t = stages.project(
        f32(g["pws"]), cam.Rcw, cam.tcw, cam.fx, cam.fy, cam.cx, cam.cy
    )
    ok &= check(us_t, us_g, name="project: us")
    ok &= check(pcs_t, pcs_g, name="project: pcs")

    cov3d_g = golden.compute_cov3d(g["rots"], g["scales"])
    cov3d_t = stages.compute_cov3d(f32(g["rots"]), f32(g["scales"]))
    ok &= check(cov3d_t, cov3d_g, name="computeCov3D")

    cov2d_g = golden.compute_cov2d(cov3d_g, pcs_g, c["Rcw"], c["fx"], c["fy"], c["width"], c["height"])
    cov2d_t = stages.compute_cov2d(cov3d_t, pcs_t, cam.Rcw, cam.fx, cam.fy, cam.width, cam.height)
    ok &= check(cov2d_t, cov2d_g, name="computeCov2D")

    twc_g = -np.asarray(c["Rcw"]).T @ np.asarray(c["tcw"])
    color_g = golden.sh2color(shs, g["pws"], twc_g, degree=3)
    color_t = stages.sh2color(f32(shs), f32(g["pws"]), cam.twc, degree=3)
    ok &= check(color_t, color_g, name="sh2Color")

    cinv_g, areas_g = golden.inverse_cov2d(cov2d_g)
    cinv_t, areas_t = stages.inverse_cov2d(cov2d_t)
    ok &= check(cinv_t, cinv_g, name="inverseCov2D: cinv")
    ok &= check(areas_t, areas_g, name="inverseCov2D: areas")

    # ---- 2. stage gradients (autograd VJP vs finite diff) -----------------
    def vjp_vs_numdiff(name, tfun, gfun, args, wrt):
        primal = np.asarray(gfun(*args))
        ct = rng.normal(size=primal.shape)
        targs = [f32(a).requires_grad_() for a in args]
        grads = torch.autograd.grad(tfun(*targs), [targs[i] for i in wrt],
                                    grad_outputs=f32(ct))
        res = True
        for i, grad in zip(wrt, grads):
            J = numerical_derivative(gfun, args, i)
            num = (ct.reshape(1, -1) @ J).reshape(np.asarray(args[i]).shape)
            res &= check(grad, num, name=f"{name}: d/d arg{i}")
        return res

    ok &= vjp_vs_numdiff(
        "project grad",
        lambda pws: stages.project(pws, cam.Rcw, cam.tcw, cam.fx, cam.fy, cam.cx, cam.cy)[0],
        lambda pws: golden.project(pws, c["Rcw"], c["tcw"], c["fx"], c["fy"], c["cx"], c["cy"])[0],
        [g["pws"]], wrt=[0],
    )
    ok &= vjp_vs_numdiff(
        "cov3d grad", stages.compute_cov3d, golden.compute_cov3d,
        [g["rots"], g["scales"]], wrt=[0, 1],
    )
    ok &= vjp_vs_numdiff(
        "cov2d grad",
        lambda c3, pc: stages.compute_cov2d(c3, pc, cam.Rcw, cam.fx, cam.fy, cam.width, cam.height),
        lambda c3, pc: golden.compute_cov2d(c3, pc, c["Rcw"], c["fx"], c["fy"], c["width"], c["height"]),
        [cov3d_g, pcs_g], wrt=[0, 1],
    )
    ok &= vjp_vs_numdiff(
        "sh2color grad",
        lambda s, p: stages.sh2color(s, p, cam.twc, degree=3),
        lambda s, p: golden.sh2color(s, p, twc_g, degree=3),
        [shs, g["pws"]], wrt=[0, 1],
    )
    ok &= vjp_vs_numdiff(
        "conic grad",
        lambda c2: stages.inverse_cov2d(c2)[0],
        lambda c2: golden.inverse_cov2d(c2)[0],
        [cov2d_g], wrt=[0],
    )

    # ---- 2b. hand-derived analytic Jacobians (third implementation) -------
    def blocks(J, out_per, in_per):
        nb = J.shape[0] // out_per
        return np.stack([
            J[i * out_per:(i + 1) * out_per, i * in_per:(i + 1) * in_per]
            for i in range(nb)
        ])

    du_a, dz_a = analytic.project_jacobians(
        g["pws"], c["Rcw"], c["tcw"], c["fx"], c["fy"])
    J = numerical_derivative(
        lambda p: golden.project(p, c["Rcw"], c["tcw"], c["fx"], c["fy"],
                                 c["cx"], c["cy"])[0], [g["pws"]], 0)
    ok &= check(du_a, blocks(J, 2, 3), name="analytic project Jacobian")
    dq_a, ds_a = analytic.cov3d_jacobians(g["rots"], g["scales"])
    J = numerical_derivative(
        lambda r: golden.compute_cov3d(r, g["scales"]), [g["rots"]], 0)
    ok &= check(dq_a, blocks(J, 6, 4), name="analytic cov3d dq Jacobian")
    J = numerical_derivative(
        lambda s: golden.compute_cov3d(g["rots"], s), [g["scales"]], 0)
    ok &= check(ds_a, blocks(J, 6, 3), name="analytic cov3d ds Jacobian")
    dsig_a, dpc_a = analytic.cov2d_jacobians(
        cov3d_g, pcs_g, c["Rcw"], c["fx"], c["fy"], c["width"], c["height"])
    J = numerical_derivative(
        lambda c3: golden.compute_cov2d(c3, pcs_g, c["Rcw"], c["fx"],
                                        c["fy"], c["width"], c["height"]),
        [cov3d_g], 0)
    ok &= check(dsig_a, blocks(J, 3, 6), name="analytic cov2d Jacobian")
    J = numerical_derivative(
        lambda pc: golden.compute_cov2d(cov3d_g, pc, c["Rcw"], c["fx"],
                                        c["fy"], c["width"], c["height"]),
        [pcs_g], 0)
    ok &= check(dpc_a, blocks(J, 3, 3), name="analytic cov2d dpc Jacobian")
    dshs_a, dpws_a = analytic.sh2color_jacobians(shs, g["pws"], twc_g)
    J = numerical_derivative(
        lambda h: golden.sh2color(h, g["pws"], twc_g), [shs], 0)
    ok &= check(dshs_a, blocks(J, 3, 48), name="analytic sh2color dshs")
    J = numerical_derivative(
        lambda p: golden.sh2color(shs, p, twc_g), [g["pws"]], 0)
    ok &= check(dpws_a, blocks(J, 3, 3), name="analytic sh2color dpws")
    J = numerical_derivative(
        lambda c2: golden.inverse_cov2d(c2)[0], [cov2d_g], 0)
    ok &= check(analytic.conic_jacobians(cov2d_g), blocks(J, 3, 3),
                name="analytic conic Jacobian")

    # ---- 3. rendered-image parity ------------------------------------------
    img_g, _ = golden.render(
        g["pws"], shs, g["alphas"], g["scales"], g["rots"],
        c["Rcw"], c["tcw"], c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
    )
    backends = ("tiled", "cuda") if on_card else ("tiled",)
    for backend in backends:
        img_b, _ = render(g["pws"], shs, g["alphas"], g["scales"], g["rots"], cam,
                          backend=backend, max_patches=2**12, need_grads=False, device=dev)
        ok &= check(img_b, img_g, name=f"render image ({backend})")

    # ---- 4. end-to-end parameter gradients ---------------------------------
    gt = rng.uniform(size=(3, c["height"], c["width"]))

    def golden_loss(pws, shs_, alphas, scales, rots):
        img, _ = golden.render(
            pws, shs_, alphas, scales, rots,
            c["Rcw"], c["tcw"], c["fx"], c["fy"], c["cx"], c["cy"],
            c["width"], c["height"],
        )
        return np.array([np.abs(img - gt).mean()])

    gargs = [g["pws"], shs, g["alphas"], g["scales"], g["rots"]]

    def autograd_grads(backend):
        params = [f32(a).requires_grad_() for a in gargs]
        img, _ = render(*params, cam, backend=backend, max_patches=2**12, device=dev)
        loss = torch.abs(img - f32(gt)).mean()
        return torch.autograd.grad(loss, params)

    grads = {b: autograd_grads(b) for b in backends}
    names = ["pws", "shs", "alphas", "scales", "rots"]
    for i, nm in enumerate(names):
        J = numerical_derivative(golden_loss, gargs, i, delta=1e-6)
        num = J.reshape(np.asarray(gargs[i]).shape)
        ok &= check(grads["tiled"][i], num, name=f"dloss/d{nm}")
        if on_card:
            # fp32 kernels vs float64 finite diff: hold the CUDA backward to a
            # scale-relative fp32 tolerance (~1e-3 of the gradient magnitude
            # is the honest fp32 bound, as for the JAX package's kernels)
            tol = max(1e-4, 1.5e-3 * float(np.abs(num).max()))
            ok &= check(grads["cuda"][i], num, atol=tol,
                        name=f"dloss/d{nm} (cuda, fp32 tol {tol:.1e})")

    # ---- 5. gradient-reduction parity PAST the kernels' block lengths -----
    # The fixture is one scan block wide; a carry bug in the segmented scan
    # once corrupted per-gaussian sums only for patch runs crossing a block
    # boundary. On the card, hold the sort-reduce path (K6 with the library
    # sort and gathers) to a scatter-add at M well past K6's 2,048-position
    # block, so inter-block carries are exercised.
    if on_card:
        m_big, n_big = 1 << 17, 4096  # ~32 patches per gaussian, 64 K6 blocks
        gsid = np.sort(rng.integers(-1, n_big, size=m_big)).astype(np.int32)
        live = gsid >= 0
        gsafe = np.maximum(gsid, 0).astype(np.int32)
        rows_ct = np.where(
            live[None, :], rng.normal(size=(LIVE_COLS, m_big)), 0.0
        ).astype(np.float32)
        counts = np.bincount(gsafe[live], minlength=n_big).astype(np.int32)
        got = sort_reduce_grads(f32(rows_ct), torch.as_tensor(gsid, device=dev),
                                torch.as_tensor(counts, device=dev)).T
        want = np.zeros((LIVE_COLS, n_big), np.float32)
        np.add.at(want.T, gsafe[live], rows_ct.T[live])
        ok &= check(got, want, atol=2e-4,
                    name=f"sort-reduce vs scatter @ M={m_big} (multi-block)")

    expected = N_CHECKS if on_card else N_CHECKS - 7
    if ran[0] != expected:
        print(f"ran {ran[0]} checks, expected {expected}")
        ok = False
    print("\nALL OK" if ok else "\nFAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
