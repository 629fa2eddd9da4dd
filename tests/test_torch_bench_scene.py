"""PyTorch port: bench_scene against the JAX package's scripts/bench_scene.py.

The JAX script runs its own ``main`` at --smoke size on the CPU (tiled
backend) with its ``train`` replaced by a recorder, so its set-up is read
as it builds it: the scene (through ``render_gt_images``), the SfM init
(through ``points_to_gaussians``), the pool, the ground truth and the eval
views (its epoch callback runs once, its renders recorded). The port's
``build_bench`` is held to it: scene and init bit-equal, the pool within
float32 rounding, the eval ids equal, the ground truth within the render
tolerance; under --realism the gains give JAX's images bit for bit (JAX's
noise set to zero) and the port's noise has mean 0 and deviation 0.015.
Then 2 epochs of training on both at a reduced size, the CLI, and the stop
at the target."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easygaussiansplatting_tpu.data.dataset as jax_dataset
import easygaussiansplatting_tpu.data.synthetic as jax_synthetic
import easygaussiansplatting_tpu.train.loop as jax_loop
from easygaussiansplatting_tpu.data.gau_io import recarray_to_arrays as jax_recarray_to_arrays
from easygaussiansplatting_tpu.models.gaussians import pool_from_arrays as jax_pool_from_arrays
from easygaussiansplatting_tpu.train import TrainConfig as JaxTrainConfig
from easygaussiansplatting_tpu.utils.image import psnr as jax_psnr
from easygaussiansplatting_tpu_torch import bench_scene
from easygaussiansplatting_tpu_torch.data.synthetic import render_gt_images
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RENDER_ATOL = 1e-4  # the render's tolerance against JAX (tests/test_torch_render.py)
SCENE_KEYS = ("pws", "rots", "scales", "alphas", "shs")
REDUCED = (500, 4, 64, 48, 2**15)  # gaussians, cameras, width, height, max_patches


class _Stop(Exception):
    pass


def _jax_script():
    spec = importlib.util.spec_from_file_location("_script_bench_scene",
                                                  ROOT / "scripts" / "bench_scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_gt(scene, config):
    """The port's renders of a JAX scene, as JAX arrays."""
    return [jnp.asarray(g.numpy()) for g in render_gt_images(scene, device="cpu")]


def _run_jax_setup(monkeypatch, *flags, zero_noise=False, render_gt=None):
    """The JAX script's main at --smoke with ``flags``, stopped at its
    ``train`` call; returns what it set up. ``render_gt`` replaces its
    ground-truth render (JAX's own by default)."""
    seen = {"eval_ids": []}
    render_gt = render_gt or jax_synthetic.render_gt_images
    p2g = jax_dataset.points_to_gaussians

    def record_gt(scene, config):
        seen["scene"] = scene
        seen["clean"] = render_gt(scene, config)
        return seen["clean"]

    def record_init(xyz, rgb):
        seen["init"] = p2g(xyz, rgb)
        return seen["init"]

    def record_render(pool, cam, config, **kw):
        seen["eval_ids"].append(int(cam.id))
        return jnp.zeros((3, cam.height, cam.width)), {}

    def stop_train(pool, cameras, gt_images, config, scene_size, epoch_cb=None, **kw):
        seen.update(pool=pool, gt=[np.asarray(g) for g in gt_images], config=config,
                    scene_size=scene_size)
        epoch_cb(1, pool)
        raise _Stop

    monkeypatch.setattr(jax_synthetic, "render_gt_images", record_gt)
    monkeypatch.setattr(jax_dataset, "points_to_gaussians", record_init)
    monkeypatch.setattr(jax_loop, "train", stop_train)
    monkeypatch.setattr(jax_loop, "render_pool_image", record_render)
    if zero_noise:
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.zeros(shape, dtype))
    monkeypatch.setattr(sys, "argv", ["bench_scene.py", "--smoke", *flags])
    with pytest.raises(_Stop):
        _jax_script().main()
    monkeypatch.undo()
    return seen


@pytest.fixture(scope="module")
def jax_smoke():
    with pytest.MonkeyPatch.context() as mp:
        return _run_jax_setup(mp)


@pytest.fixture(scope="module")
def port_smoke():
    return bench_scene.build_bench(smoke=True, device="cpu")


def test_scene_and_init_bit_equal_to_jax(jax_smoke, port_smoke):
    for k in SCENE_KEYS:
        np.testing.assert_array_equal(port_smoke.scene[k], jax_smoke["scene"][k], err_msg=k)
    assert port_smoke.scene["scene_size"] == jax_smoke["scene_size"]
    for a, b in zip(port_smoke.scene["cameras"], jax_smoke["scene"]["cameras"]):
        for f in ("Rcw", "tcw", "fx", "fy", "cx", "cy", "width", "height", "id"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    gs, n_init = bench_scene.sfm_init(port_smoke.scene, 2000, realism=False)
    want = jax_recarray_to_arrays(jax_smoke["init"])
    assert n_init == port_smoke.n_init == 1200 == len(want["pws"])
    for k in SCENE_KEYS:
        np.testing.assert_array_equal(gs[k], want[k], err_msg=k)


def test_pool_capacity_and_eval_ids_match_jax(jax_smoke, port_smoke):
    jpool = jax_smoke["pool"]
    assert port_smoke.capacity == jpool.capacity == 3072
    for k in GROUPS:
        np.testing.assert_allclose(getattr(port_smoke.pool, k).detach().numpy(),
                                   np.asarray(getattr(jpool, k)), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(port_smoke.pool.alive.numpy(), np.asarray(jpool.alive))
    assert port_smoke.eval_ids == jax_smoke["eval_ids"] == [0, 2, 4, 6]
    cfg = jax_smoke["config"]
    assert (port_smoke.config.max_patches, port_smoke.config.adaptive_budget,
            port_smoke.config.epochs) == (cfg.max_patches, cfg.adaptive_budget, cfg.epochs)
    assert port_smoke.config.backend == "tiled" and cfg.backend == "tiled"


def test_ground_truth_within_render_tolerance(jax_smoke, port_smoke):
    assert len(port_smoke.gt_images) == len(jax_smoke["gt"]) == 8
    for a, b in zip(port_smoke.gt_images, jax_smoke["gt"]):
        assert a.shape == (3, 112, 160) and a.device.type == "cpu"
        np.testing.assert_allclose(a.numpy(), b, atol=RENDER_ATOL)


def test_realism_gains_and_noise(monkeypatch):
    seen = _run_jax_setup(monkeypatch, "--realism", zero_noise=True, render_gt=_port_gt)
    bench = bench_scene.build_bench(smoke=True, realism=True, device="cpu", oracle_gt=True)
    for k in SCENE_KEYS:  # the background shell
        np.testing.assert_array_equal(bench.scene[k], seen["scene"][k], err_msg=k)
    assert len(bench.scene["pws"]) == 2000 + 250
    # JAX's images with its noise at zero are clip(clean * gain): the port's
    # gains reproduce them bit for bit
    assert len(bench.gains) == 8
    for clean, noisy, gain in zip(seen["clean"], seen["gt"], bench.gains):
        np.testing.assert_array_equal(
            np.clip(np.asarray(clean) * np.float32(gain), 0.0, 1.0), noisy)
    assert len(set(bench.gains)) == 8 and max(abs(g - 1) for g in bench.gains) < 0.15
    clean = [torch.from_numpy(np.array(c)) for c in seen["clean"]]  # the port's renders
    noise = []
    for c, n, g in zip(clean, bench.gt_images, bench.gains):
        scaled = c * g
        inside = (n > 0) & (n < 1) & (scaled > 0.05) & (scaled < 0.95)
        noise.append((n - scaled)[inside])
    noise = torch.cat(noise)
    assert noise.numel() > 10_000
    assert abs(float(noise.mean())) <= 0.05 * 0.015
    assert abs(float(noise.std()) - 0.015) <= 0.05 * 0.015


def test_two_epochs_match_jax_train(monkeypatch):
    """2 epochs (no densify, no alpha reset) at REDUCED size from the same
    init and the same ground truth: each epoch's loss within rel 1e-4 of
    JAX's, each epoch's eval PSNR within 0.05 dB."""
    monkeypatch.setattr(bench_scene, "SMOKE", REDUCED)
    bench = bench_scene.build_bench(smoke=True, device="cpu", epochs=2)
    gts = [g.numpy() for g in bench.gt_images]
    state = bench_scene.run(bench, target_psnr=99.0, log_fn=lambda *_: None)
    hist = state["history"]

    s = bench.scene
    gs, _ = bench_scene.sfm_init(s, REDUCED[0], realism=False)
    jpool = jax_pool_from_arrays(gs["pws"], gs["rots"], gs["scales"], gs["alphas"], gs["shs"],
                                 capacity=bench.capacity)
    jcfg = JaxTrainConfig(epochs=2, backend="tiled", max_patches=REDUCED[4],
                          adaptive_budget=False)
    jpsnr = []

    def cb(epoch, pool, adam_state=None, stats=None, key=None, history=None):
        vals = []
        for i in bench.eval_ids:
            img, _ = jax_loop.render_pool_image(pool, jcams[i], jcfg)
            vals.append(float(jax_psnr(jnp.clip(img, 0, 1), jnp.clip(jnp.asarray(gts[i]), 0, 1))))
        jpsnr.append(float(np.mean(vals)))

    jcams = jax_synthetic.make_synthetic_scene(seed=42, n_gaussians=REDUCED[0],
                                               n_cams=REDUCED[1], width=REDUCED[2],
                                               height=REDUCED[3], log_scale_mean=-3.4)["cameras"]
    _, jhist = jax_loop.train(jpool, jcams, [jnp.asarray(g) for g in gts], jcfg,
                              s["scene_size"], seed=0, log_fn=lambda *_: None,
                              eval_every=10**9, epoch_cb=cb)
    assert len(hist["loss"]) == len(jhist["loss"]) == 2
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    got = [r["psnr"] for r in state["curve"]]
    np.testing.assert_allclose(got, jpsnr, atol=0.05)
    assert state["epoch_hit"] is None and [r["epoch"] for r in state["curve"]] == [1, 2]


def test_target_below_the_first_epoch_stops_after_it(monkeypatch):
    monkeypatch.setattr(bench_scene, "SMOKE", REDUCED)
    bench = bench_scene.build_bench(smoke=True, device="cpu", epochs=3)
    state = bench_scene.run(bench, target_psnr=0.0, log_fn=lambda *_: None)
    assert state["epoch_hit"] == 1 and len(state["curve"]) == 1
    assert len(state["history"]["loss"]) == 1  # StopIteration ended train after epoch 1
    lines = bench_scene.result_lines(state, 0.0, realism=False, full=False)
    assert lines[1]["metric"] == "time_to_psnr25" and "epoch 1," in lines[1]["unit"]
    assert lines[0]["attribution"]["steps_wall_s"] >= 0


def test_cli_smoke_prints_jax_keys(capsys):
    lines, state = bench_scene.main(["--smoke", "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")] == lines
    assert state["history"]["overflow_steps"] == [0]
    assert "init 1200 gaussians (capacity 3072), 8 cams 160x112, backend=tiled" in out
    assert len(lines) == 2
    assert set(lines[0]) == {"attribution", "curve"}
    (row,) = lines[0]["curve"]
    assert set(row) == {"epoch", "wall_s", "psnr", "alive", "budget", "overflow_steps",
                        "t_steps_wall", "t_device_est", "t_densify", "t_eval"}
    assert row["epoch"] == 1 and row["overflow_steps"] == 0 and np.isfinite(row["psnr"])
    assert set(lines[0]["attribution"]) == {"steps_wall_s", "device_est_s", "densify_s",
                                            "eval_s", "host_overhead_s"}
    assert lines[1]["metric"] == "time_to_psnr25"
    assert set(lines[1]) == {"metric", "value", "unit", "vs_baseline"}


def test_entry_point_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_scene.main(["--smoke", "--epochs", "1"])
