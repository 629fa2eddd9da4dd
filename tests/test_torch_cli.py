"""PyTorch port: the train and bench CLIs in a subprocess on the CPU, and
the train CLI's --gs, --preview, --profile and --debug-nans; the train,
eval and render CLIs with --path on a COLMAP scene, and the render CLI's
dense and golden backends."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data.gau_io import load_gs as jax_load_gs
from easygaussiansplatting_tpu_torch import eval as port_eval
from easygaussiansplatting_tpu_torch import golden
from easygaussiansplatting_tpu_torch.data import colmap
from easygaussiansplatting_tpu_torch.data.fixtures import (
    example_gaussians,
    rotmat2qvec,
    write_colmap_scene,
)
from easygaussiansplatting_tpu_torch.data.gau_io import (
    arrays_to_recarray,
    recarray_to_arrays,
    save_gs,
)
from easygaussiansplatting_tpu_torch.data.image_io import decode_png
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene, render_gt_images
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.render import main as render_main
from easygaussiansplatting_tpu_torch.train.__main__ import main as train_main
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import density_stats_init
from easygaussiansplatting_tpu_torch.train.loop import check_finite, make_train_step
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init
from easygaussiansplatting_tpu_torch.utils.image import to_uint8

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


def _colmap_scene(root):
    """A COLMAP scene of the synthetic scene (64 gaussians, 3 views): photos
    at 128x96, rendered by the port with doubled intrinsics and written as
    PNG, one PINHOLE camera, the views' poses, and the gaussians' positions
    jittered as SfM points with colours from SH0."""
    scene = make_synthetic_scene(seed=3, n_gaussians=64, n_cams=3, width=64, height=48)
    cam0 = scene["cameras"][0]
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 128, 96, 2.0 * np.array(
        [cam0.fx, cam0.fy, cam0.cx, cam0.cy], np.float64))}
    images, photos = {}, {}
    args = [scene[k] for k in ("pws", "shs", "alphas", "scales", "rots")]
    for i, cam in enumerate(scene["cameras"], start=1):
        big = Camera.from_dict({"Rcw": cam.Rcw, "tcw": cam.tcw, "fx": 2 * cam.fx,
                                "fy": 2 * cam.fy, "cx": 2 * cam.cx, "cy": 2 * cam.cy,
                                "width": 128, "height": 96})
        img, _ = render(*args, big, sh_degree=0, need_grads=False, device="cpu")
        images[i] = colmap.ColmapImage(i, rotmat2qvec(cam.Rcw), np.asarray(cam.tcw, np.float64),
                                       1, f"view{i}.png")
        photos[f"view{i}.png"] = to_uint8(img.numpy())
    rng = np.random.default_rng(7)
    xyz = scene["pws"] + rng.normal(scale=0.01, size=scene["pws"].shape)
    rgb = np.clip((scene["shs"] * 0.28209479177387814 + 0.5) * 255, 0, 255).astype(np.uint8)
    write_colmap_scene(root, cams, images, xyz, rgb, photos)
    return scene


def test_train_eval_render_clis_on_a_colmap_scene(tmp_path, capsys):
    """--path through the three CLIs on the CPU: the train CLI (a
    subprocess) trains 2 epochs from the SfM points, and with --gs from
    that file instead; eval scores final.npy against the photos at 0.5; the
    render CLI draws camera 1 at 0.5 (64x48) with the auto, dense and golden
    backends, dense within 1e-5 of golden's 8-bit image levels (one level)
    and golden equal to the port's golden.render."""
    scene_dir = tmp_path / "scene"
    scene = _colmap_scene(scene_dir)
    out = _run("easygaussiansplatting_tpu_torch.train", "--path", str(scene_dir),
               "--resize-rate", "0.5", "--epochs", "2", "--save-every", "2", "--device", "cpu",
               "--out", str(tmp_path / "run"))
    assert "3 cameras, 64 initial gaussians" in out and "[epoch 2] loss=" in out
    assert "steps that dropped patches or rows: 0" in out
    final = tmp_path / "run" / "final.npy"
    assert len(np.load(final)) == 64

    history = train_main(["--path", str(scene_dir), "--resize-rate", "0.5", "--epochs", "1",
                          "--device", "cpu", "--gs", str(final), "--out", str(tmp_path / "gs")])
    assert np.isfinite(history["loss"]).all()

    port_eval.main(["--gs", str(final), "--path", str(scene_dir), "--resize-rate", "0.5",
                    "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("mean over 3 views: psnr")

    pngs = {}
    for backend in ("auto", "dense", "golden"):
        png = tmp_path / f"{backend}.png"
        render_main(["--gs", str(final), "--path", str(scene_dir), "--cam-index", "1",
                     "--resize-rate", "0.5", "--backend", backend, "--device", "cpu",
                     "--out", str(png)])
        pngs[backend] = decode_png(png.read_bytes())[0].astype(int)
        assert pngs[backend].shape == (48, 64, 3)
    assert np.abs(pngs["dense"] - pngs["golden"]).max() <= 1
    assert np.abs(pngs["auto"] - pngs["golden"]).max() <= 1
    g = recarray_to_arrays(np.load(final))
    cam = scene["cameras"][1]
    want, _ = golden.render(g["pws"], g["shs"], g["alphas"], g["scales"], g["rots"],
                            np.asarray(cam.Rcw, np.float64), np.asarray(cam.tcw, np.float64),
                            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), 64, 48)
    assert np.array_equal(pngs["golden"], to_uint8(want))


def test_render_cli_dense_and_golden_on_the_fixture(tmp_path):
    """Without --path and --gs the render CLI draws the 4-gaussian fixture:
    --backend dense and golden give the same 8-bit image within one level."""
    got = {}
    for backend in ("dense", "golden"):
        png = tmp_path / f"{backend}.png"
        render_main(["--backend", backend, "--device", "cpu", "--out", str(png)])
        got[backend] = decode_png(png.read_bytes())[0].astype(int)
    assert got["dense"].shape == (16, 32, 3)
    assert np.abs(got["dense"] - got["golden"]).max() <= 1
