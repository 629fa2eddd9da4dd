"""PyTorch port: the train and bench CLIs in a subprocess on the CPU, and
the train CLI's --gs, --preview, --profile and --debug-nans."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data.gau_io import load_gs as jax_load_gs
from easygaussiansplatting_tpu_torch.data.fixtures import example_gaussians
from easygaussiansplatting_tpu_torch.data.gau_io import arrays_to_recarray, save_gs
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene, render_gt_images
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import density_stats_init
from easygaussiansplatting_tpu_torch.train.loop import check_finite, make_train_step
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _run(*args):
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=ENV)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_train_cli_writes_its_files_and_resumes(tmp_path):
    """The JAX CLI's synthetic scene (512 gaussians, 8 views, 128x96) for
    one epoch, then --resume for a second."""
    out = _run("easygaussiansplatting_tpu_torch.train", "--synthetic", "--epochs", "1",
               "--device", "cpu", "--out", str(tmp_path))
    assert "[epoch 1] loss=" in out
    for name in ("final.ply", "final.npy", "checkpoint.npz", "epoch0001.npy"):
        assert (tmp_path / name).exists(), name
    ply = jax_load_gs(tmp_path / "final.ply")  # the official layout, read by the JAX package
    assert len(ply) == 512 and np.isfinite(ply["pw"]).all()
    out = _run("easygaussiansplatting_tpu_torch.train", "--synthetic", "--epochs", "2",
               "--device", "cpu", "--out", str(tmp_path), "--resume",
               str(tmp_path / "checkpoint.npz"))
    assert "resumed from" in out and "at epoch 1" in out
    assert "[epoch 2] loss=" in out and "[epoch 1] loss=" not in out
    assert (tmp_path / "epoch0002.npy").exists()
    with np.load(tmp_path / "checkpoint.npz") as z:
        assert int(z["meta/epoch"]) == 2 and "meta/torch_rng" in z


def test_bench_cli_prints_one_json_line():
    out = _run("easygaussiansplatting_tpu_torch.bench", "--device", "cpu")
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "fwd_bwd_throughput" and rec["unit"] == "Mpix/s"
    assert rec["device"] == "cpu"
    for k in ("value", "vs_baseline", "fwd_throughput"):
        assert rec[k] > 0, k


def test_train_cli_ignores_gs_under_synthetic(tmp_path):
    """train.py reads --gs only for a COLMAP scene (train.py:99-106), so
    --synthetic --gs trains from the synthetic scene's perturbed copy: the
    same final.npy as without --gs, and a warning that --gs was ignored."""
    g = example_gaussians()
    gs_file = tmp_path / "other.npy"
    save_gs(gs_file, arrays_to_recarray(g["pws"], g["rots"], g["scales"], g["alphas"], g["shs"]))
    common = ("easygaussiansplatting_tpu_torch.train", "--synthetic", "--epochs", "1",
              "--device", "cpu")
    _run(*common, "--out", str(tmp_path / "plain"))
    out = _run(*common, "--gs", str(gs_file), "--out", str(tmp_path / "gs"))
    assert out.startswith(f"warning: --gs {gs_file} is ignored")
    a = np.load(tmp_path / "plain" / "final.npy")
    b = np.load(tmp_path / "gs" / "final.npy")
    assert len(a) == 512 and a.dtype == b.dtype
    for name in a.dtype.names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_train_cli_preview_profile_debug_nans(tmp_path):
    out = _run("easygaussiansplatting_tpu_torch.train", "--synthetic", "--epochs", "1",
               "--device", "cpu", "--out", str(tmp_path / "run"), "--preview", "--profile",
               str(tmp_path / "prof"), "--debug-nans")
    assert (tmp_path / "run" / "preview0001.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    trace = tmp_path / "prof" / "trace.json"
    assert f"wrote profiler trace to {trace}" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert "[epoch 1] loss=" in out


@pytest.mark.parametrize("bad", ["loss", "pws"])
def test_debug_nans_names_the_group(bad):
    """check_finite on planted values, then a step from a pool holding a NaN
    position: with debug_nans the step raises, naming what went non-finite."""
    grads = {k: torch.zeros(3) for k in ("pws", "shs", "alphas")}
    loss = torch.tensor(0.5)
    check_finite(loss, grads)
    if bad == "loss":
        loss = torch.tensor(float("nan"))
    else:
        grads["pws"][1] = float("inf")
    with pytest.raises(FloatingPointError, match="the loss" if bad == "loss" else "of pws"):
        check_finite(loss, grads)

    scene = make_synthetic_scene(seed=0, n_gaussians=64, n_cams=1, width=32, height=24)
    gt = render_gt_images(scene, device="cpu")[0]
    pws = scene["pws"].copy()
    pws[5] = np.nan
    pool = pool_from_arrays(pws, scene["rots"], scene["scales"], scene["alphas"], scene["shs"],
                            capacity=64, device="cpu")
    cfg = TrainConfig(max_patches=4096)
    step = make_train_step(cfg, scene["scene_size"], 1, device="cpu", debug_nans=True)
    with pytest.raises(FloatingPointError, match="non-finite values in the"):
        step(pool, adam_init(pool.params()), density_stats_init(64, "cpu"), scene["cameras"][0],
             gt)
