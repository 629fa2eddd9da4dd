"""PyTorch port: eval (easygaussiansplatting_tpu_torch/eval.py) against the
logic of the JAX package's eval.py on the same .npy file, each package
rendering the synthetic scene's ground truth and the trained set itself (JAX
on its "tiled" backend); and the CLI on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data.gau_io import load_gs as jax_load_gs
from easygaussiansplatting_tpu.data.gau_io import recarray_to_arrays as jax_to_arrays
from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene as jax_scene
from easygaussiansplatting_tpu.data.synthetic import render_gt_images as jax_gt_images
from easygaussiansplatting_tpu.ops.loss import ssim as jax_ssim
from easygaussiansplatting_tpu.ops.rasterize import render as jax_render
from easygaussiansplatting_tpu.utils.image import psnr as jax_psnr
from easygaussiansplatting_tpu_torch import eval as port_eval
from easygaussiansplatting_tpu_torch.data.gau_io import (
    arrays_to_recarray,
    load_gs,
    recarray_to_arrays,
    save_gs,
)
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene, render_gt_images

torch.set_num_threads(2)

N_VIEWS = 4


@pytest.fixture()
def trained_npy(tmp_path):
    """The synthetic scene perturbed as the train CLI starts it, saved as a
    .npy gaussian file."""
    scene = make_synthetic_scene(seed=0, n_gaussians=512, n_cams=8, width=128, height=96)
    rng = np.random.default_rng(3)
    path = tmp_path / "trained.npy"
    save_gs(path, arrays_to_recarray(scene["pws"] + rng.normal(scale=0.01, size=(512, 3)),
                                     scene["rots"], scene["scales"], scene["alphas"],
                                     scene["shs"] * 0.9))
    return path


def _jax_rows(path, n):
    """eval.py's per-view loop (eval.py:35-72) on the "tiled" backend."""
    scene = jax_scene(seed=0, n_gaussians=512, n_cams=8, width=128, height=96)
    images = jax_gt_images(scene)
    a = jax_to_arrays(jax_load_gs(path))
    shs = a["shs"].reshape(len(a["pws"]), -1)
    degree = int(np.sqrt(max(1, shs.shape[1] // 3))) - 1
    gs_args = (jnp.asarray(a["pws"], jnp.float32), jnp.asarray(shs, jnp.float32),
               jnp.asarray(a["alphas"], jnp.float32).reshape(-1),
               jnp.asarray(a["scales"], jnp.float32), jnp.asarray(a["rots"], jnp.float32))
    rows = []
    for i in range(n):
        img, _ = jax_render(*gs_args, scene["cameras"][i], need_grads=False, backend="tiled",
                            max_patches=2**20, sh_degree=degree)
        gt = jnp.asarray(images[i], jnp.float32)
        img = jnp.clip(img, 0.0, 1.0)
        rows.append((float(jax_psnr(img, jnp.clip(gt, 0, 1))), float(jax_ssim(img, gt)),
                     float(jnp.mean(jnp.abs(img - gt)))))
    return np.array(rows)


def test_eval_matches_jax_eval(trained_npy, capsys):
    """Per view within 1e-3 dB of PSNR and 1e-5 of SSIM and L1: the two
    packages' float32 renders (ground truth and trained set) differ by
    ~1e-6 per pixel."""
    assert port_eval.main(["--gs", str(trained_npy), "--synthetic", "--device", "cpu",
                           "--max-views", str(N_VIEWS)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = np.array([[float(ln.split()[k]) for k in (3, 5, 7)] for ln in lines[:N_VIEWS]])
    assert lines[-1].startswith(f"mean over {N_VIEWS} views: psnr ")
    want = _jax_rows(trained_npy, N_VIEWS)
    # the printed lines round to 2 and 4 decimals; the returned rows are exact
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=0.006)
    scene = make_synthetic_scene(seed=0, n_gaussians=512, n_cams=8, width=128, height=96)
    a = recarray_to_arrays(load_gs(trained_npy))
    rows = np.array(port_eval.evaluate_views(
        (a["pws"], a["shs"].reshape(512, -1), a["alphas"].reshape(-1), a["scales"], a["rots"]),
        scene["cameras"][:N_VIEWS], render_gt_images(scene, device="cpu")[:N_VIEWS],
        sh_degree=0, device="cpu", log_fn=lambda *_: None))
    assert np.isfinite(rows).all() and (rows[:, 0] > 20).all()
    np.testing.assert_allclose(rows[:, 0], want[:, 0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(rows[:, 1:], want[:, 1:], atol=1e-5, rtol=0)


def test_eval_cli_refuses_colmap_scenes(trained_npy, capsys, tmp_path):
    """COLMAP scenes are ported (tests/test_torch_cli.py evaluates one): the
    CLI refuses a run with neither --path nor --synthetic, as JAX eval.py
    does, and a --path that holds no sparse model."""
    with pytest.raises(SystemExit) as exc:
        port_eval.main(["--gs", str(trained_npy), "--device", "cpu"])
    assert exc.value.code == 2
    assert "need --path or --synthetic" in capsys.readouterr().err
    with pytest.raises(OSError):  # the reader's: no cameras.bin to parse
        port_eval.main(["--gs", str(trained_npy), "--path", str(tmp_path), "--device", "cpu"])
