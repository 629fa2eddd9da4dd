"""PyTorch port: the epoch driver against the JAX package. PatchBudget and
the budget ladder exactly; ``train`` against JAX ``train`` over 4 epochs
with a densify and an alpha reset (the JAX side on its tiled backend, the
port on its plain path, both on the CPU, the port fed the JAX split noise);
the reaction to a patch budget overflow at the end of an epoch and in the
middle of one."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu.models.gaussians import pool_from_arrays as jax_pool_from_arrays
from easygaussiansplatting_tpu.train import TrainConfig as JaxTrainConfig
from easygaussiansplatting_tpu.train.loop import PatchBudget as JaxPatchBudget
from easygaussiansplatting_tpu.train.loop import _round_budget as jax_round_budget
from easygaussiansplatting_tpu.train.loop import train as jax_train
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy, pool_from_numpy
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.train import loop
from easygaussiansplatting_tpu_torch.train.config import TrainConfig

torch.set_num_threads(2)

W, H = 48, 32


@pytest.mark.parametrize("quantum", [256, 16384])
def test_round_budget_matches_jax(quantum):
    ns = [0, 1, quantum - 1, quantum, quantum + 1, 557_056, 576_460, 589_824, 2**20,
          2**21 + 3, 10**7] + list(range(1, 40 * quantum, quantum // 4 + 7))
    for n in ns:
        assert loop._round_budget(n, quantum) == jax_round_budget(n, quantum), n


@pytest.mark.parametrize("kw", [
    dict(max_patches=2**18, budget_headroom=1.5),
    dict(max_patches=557_056),                                   # starts on the rung 589,824
    dict(max_patches=256, budget_quantum=256, budget_headroom=1.5),
    dict(max_patches=2**18, adaptive_budget=False),
])
def test_patch_budget_matches_jax(kw):
    """A sweep of observations: growth, shrink, and no change."""
    port, jax_ = loop.PatchBudget(TrainConfig(**kw)), JaxPatchBudget(JaxTrainConfig(**kw))
    assert port.value == jax_.value
    rng = np.random.default_rng(0)
    obs = [int(port.value * f) for f in (0.5, 0.95, 1.3, 0.2, 0.01, 0.91, 3.0, 0.0)]
    obs += [int(x) for x in rng.integers(0, 4 * port.value, 40)]
    changed = 0
    for o in obs:
        a, b = port.update(o), jax_.update(o)
        assert a == b and port.value == jax_.value, o
        changed += a
    assert changed > 0 if port.config.adaptive_budget else changed == 0


def _scene(seed, n, n_cams, cap, perturb=True):
    """A synthetic scene at 48x32, its JAX pool (opacities and colours
    perturbed, free slots past n), and ground truth from the unperturbed
    scene rendered by the port."""
    s = make_synthetic_scene(seed=seed, n_gaussians=n, n_cams=n_cams, width=W, height=H)
    alphas, shs = s["alphas"], s["shs"]
    if perturb:
        rng = np.random.default_rng(seed + 10)
        alphas = np.clip(alphas + rng.normal(size=n) * 0.1, 0.05, 0.95)
        shs = shs + rng.normal(size=shs.shape) * 0.2
    jpool = jax_pool_from_arrays(s["pws"], s["rots"], s["scales"], alphas, shs, capacity=cap)
    gts = [render(s["pws"], s["shs"], s["alphas"], s["scales"], s["rots"],
                  camera_from_numpy(c), sh_degree=0, need_grads=False, device="cpu")[0].numpy()
           for c in s["cameras"]]
    return s, jpool, gts


def _run_both(s, jpool, gts, seed, monkeypatch, **cfg):
    """JAX train (tiled backend) and the port's train from one pool; the
    port draws the split noise of JAX's key sequence. Returns (JAX history,
    JAX log lines, port history, port log lines, the port's smallest
    relative distance of an averaged gradient from grad_threshold at each
    densify)."""
    jlogs, logs, margins = [], [], []
    _, jhist = jax_train(jpool, s["cameras"], [jnp.asarray(g) for g in gts],
                         JaxTrainConfig(backend="tiled", **cfg), s["scene_size"], seed=seed,
                         log_fn=jlogs.append, eval_every=2)
    key = [jax.random.PRNGKey(seed)]

    def jax_noise(capacity, generator, device):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(sub, (capacity, 3))))

    densify = loop.densify_and_prune

    def densify_and_check(pool, adam_state, stats, noise, scene_size, config):
        g = torch.where(stats.cunt > 0, stats.grad_accum / stats.cunt.clamp(min=1), 0.0)
        g = g[pool.alive & (stats.cunt > 0)]
        margins.append(float((g / config.grad_threshold - 1.0).abs().min()))
        return densify(pool, adam_state, stats, noise, scene_size, config)

    monkeypatch.setattr(loop, "split_noise", jax_noise)
    monkeypatch.setattr(loop, "densify_and_prune", densify_and_check)
    leaves = {k: np.asarray(getattr(jpool, k)) for k in GROUPS + ("alive",)}
    _, hist = loop.train(pool_from_numpy(leaves, "cpu"),
                         [camera_from_numpy(c) for c in s["cameras"]], gts,
                         TrainConfig(backend="tiled", **cfg), s["scene_size"], seed=seed,
                         log_fn=logs.append, eval_every=2)
    return jhist, jlogs, hist, logs, margins


def _without_numbers(lines):
    return [re.sub(r"(loss|psnr)=[-0-9.]+", r"\1=", ln) for ln in lines]


def _assert_histories_match(hist, jhist, logs, jlogs):
    assert list(hist) == list(jhist)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    for k in ("n_alive", "budget", "overflow_steps"):
        assert hist[k] == jhist[k], k
    assert [e for e, _ in hist["psnr"]] == [e for e, _ in jhist["psnr"]]
    np.testing.assert_allclose([p for _, p in hist["psnr"]], [p for _, p in jhist["psnr"]],
                               rtol=1e-4)
    assert _without_numbers(logs) == _without_numbers(jlogs)


def test_train_matches_jax_train(monkeypatch):
    """4 epochs x 2 views, capacity 130 for 100 gaussians: densify at epochs
    2 and 4 (some candidates find no free slot), alpha reset at epoch 3. No
    averaged gradient lies within 1e-3 (relative) of grad_threshold, so no
    densify decision can flip on float noise."""
    seed = 0
    s, jpool, gts = _scene(seed, n=100, n_cams=2, cap=130)
    jhist, jlogs, hist, logs, margins = _run_both(
        s, jpool, gts, seed, monkeypatch, epochs=4, max_patches=4096, densify_every_epochs=2,
        reset_alpha_every_epochs=3)
    assert len(margins) == 2 and min(margins) > 1e-3, margins
    _assert_histories_match(hist, jhist, logs, jlogs)
    assert any("densify" in ln and "dropped=" in ln for ln in logs)
    assert any("alpha reset" in ln for ln in logs)
    assert hist["n_alive"][0] == 100 and hist["n_alive"][1] == 130


def test_overflow_at_the_end_of_an_epoch_grows_the_budget_as_jax(monkeypatch):
    """A 256-patch budget for ~500 patches per view: every step drops
    patches, and the budget grows at the end of epoch 1 along the ladder;
    2 views, so the mid-epoch check never fires."""
    s, jpool, gts = _scene(2, n=160, n_cams=2, cap=160, perturb=False)
    jhist, jlogs, hist, logs, _ = _run_both(
        s, jpool, gts, 2, monkeypatch, epochs=2, max_patches=256, budget_quantum=256,
        budget_headroom=1.5, densify_every_epochs=100, reset_alpha_every_epochs=100)
    _assert_histories_match(hist, jhist, logs, jlogs)
    assert hist["overflow_steps"][0] == 2 and hist["overflow_steps"][1] == 0
    assert hist["budget"][0] > 256 and any("patch budget ->" in ln for ln in logs)


def test_overflow_in_the_middle_of_an_epoch_grows_the_budget_as_jax(monkeypatch):
    """16 views, so the check after the 16th step fires inside epoch 1."""
    s, jpool, gts = _scene(2, n=160, n_cams=16, cap=160, perturb=False)
    jhist, jlogs, hist, logs, _ = _run_both(
        s, jpool, gts, 2, monkeypatch, epochs=1, max_patches=256, budget_quantum=256,
        budget_headroom=1.5, densify_every_epochs=100, reset_alpha_every_epochs=100)
    _assert_histories_match(hist, jhist, logs, jlogs)
    assert hist["overflow_steps"][0] >= 16
    assert any("WARNING" in ln and "overflow" in ln for ln in logs)
    assert any("patch budget ->" in ln and "mid-epoch" in ln for ln in logs)


def test_call_epoch_cb_passes_history_only_to_callbacks_that_take_it():
    seen = []
    loop.call_epoch_cb(lambda e, pool, adam, stats, gen: seen.append((e, gen)), 3, None, None,
                       None, "gen", {"loss": []})
    loop.call_epoch_cb(lambda e, *a, history: seen.append(history), 3, None, None, None, None,
                       {"loss": [1.0]})
    assert seen == [(3, "gen"), {"loss": [1.0]}]
