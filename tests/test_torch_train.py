"""PyTorch port: the pool, Adam, density control and one whole training step
against the JAX package, each started from the same state (carried across
as numpy), and a few CPU steps that lower the loss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu.models.gaussians import pool_from_arrays as jax_pool_from_arrays
from easygaussiansplatting_tpu.train import TrainConfig as JaxTrainConfig
from easygaussiansplatting_tpu.train import adam_init as jax_adam_init
from easygaussiansplatting_tpu.train import adam_update as jax_adam_update
from easygaussiansplatting_tpu.train import densify_and_prune as jax_densify
from easygaussiansplatting_tpu.train import make_train_step as jax_make_train_step
from easygaussiansplatting_tpu.train import reset_alpha as jax_reset_alpha
from easygaussiansplatting_tpu.train import update_density_stats as jax_update_stats
from easygaussiansplatting_tpu.train.density import DensityStats as JaxDensityStats
from easygaussiansplatting_tpu.train.optimizer import make_lr_fns as jax_make_lr_fns
from easygaussiansplatting_tpu_torch.models.convert import (
    adam_state_from_numpy,
    camera_from_numpy,
    density_stats_from_numpy,
    pool_from_numpy,
)
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS, pool_from_arrays
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import (
    density_stats_init,
    densify_and_prune,
    reset_alpha,
    split_noise,
    update_density_stats,
)
from easygaussiansplatting_tpu_torch.train.loop import make_train_step
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init, adam_update, make_lr_fns

torch.set_num_threads(2)

W, H = 48, 32
SCENE_SIZE = 5.5


def _leaves(jpool):
    return {k: np.asarray(getattr(jpool, k)) for k in GROUPS + ("alive",)}


def _jax_state(js):
    return js.count, {k: np.asarray(v) for k, v in js.mu.items()}, \
        {k: np.asarray(v) for k, v in js.nu.items()}


def _scene(seed=0, n=100, cap=130):
    """A small synthetic scene, its pool with perturbed opacities and
    colours (free slots past n), and ground truth from the unperturbed
    scene."""
    s = make_synthetic_scene(seed=seed, n_gaussians=n, n_cams=2, width=W, height=H)
    rng = np.random.default_rng(seed + 10)
    alphas = np.clip(s["alphas"] + rng.normal(size=n) * 0.1, 0.05, 0.95)
    shs = s["shs"] + rng.normal(size=s["shs"].shape) * 0.2
    jpool = jax_pool_from_arrays(s["pws"], s["rots"], s["scales"], alphas, shs, capacity=cap)
    gts = []
    for cam in s["cameras"]:
        img, _ = render(s["pws"], s["shs"], s["alphas"], s["scales"], s["rots"],
                        camera_from_numpy(cam), sh_degree=0, need_grads=False, device="cpu")
        gts.append(img.numpy())
    return s, jpool, gts


def test_pool_from_arrays_matches_jax(rng):
    n = 20
    rots = rng.normal(size=(n, 4))
    args = (rng.normal(size=(n, 3)), rots, np.exp(rng.normal(size=(n, 3))),
            rng.uniform(size=n), rng.normal(size=(n, 12)))
    jpool = jax_pool_from_arrays(*args, capacity=25)
    pool = pool_from_arrays(*args, capacity=25, device="cpu")
    for k, v in _leaves(jpool).items():
        np.testing.assert_array_equal(getattr(pool, k).detach().numpy(), v, err_msg=k)
    assert int(pool.n_alive()) == n and pool.capacity == 25
    jact = jpool.activated()
    for got, want in zip(pool.activated(), jact):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="capacity"):
        pool_from_arrays(*args, capacity=5, device="cpu")


def test_adam_update_matches_jax(rng):
    """Identical gradients, from a state with count > 0 and non-zero moments.
    1e-6: the same float32 expressions, rounded once more or less here and
    there."""
    _, jpool, _ = _scene()
    cfg, jcfg = TrainConfig(), JaxTrainConfig()
    params = jpool.params()
    grads = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32) for k, v in params.items()}
    js = jax_adam_init(params)
    js = dataclasses.replace(
        js, count=jnp.int32(7),
        mu={k: jnp.asarray(rng.normal(size=v.shape) * 0.1, jnp.float32) for k, v in params.items()},
        nu={k: jnp.asarray(rng.uniform(size=v.shape) * 0.1, jnp.float32) for k, v in params.items()})
    new_params, new_js = jax_adam_update(grads, js, params, jax_make_lr_fns(jcfg, SCENE_SIZE, 100))
    pool = pool_from_numpy(_leaves(jpool), device="cpu")
    state = adam_state_from_numpy(*_jax_state(js), device="cpu")
    adam_update({k: torch.from_numpy(np.array(v)) for k, v in grads.items()}, state,
                pool.params(), make_lr_fns(cfg, SCENE_SIZE, 100))
    assert state.count == int(new_js.count) == 8
    for k in GROUPS:
        np.testing.assert_allclose(getattr(pool, k).detach().numpy(), np.asarray(new_params[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(new_js.mu[k]), atol=1e-7,
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(new_js.nu[k]), atol=1e-7,
                                   rtol=1e-6, err_msg=k)
    fresh = adam_init(pool.params())
    assert fresh.count == 0 and all(float(v.abs().sum()) == 0 for v in fresh.mu.values())


def test_update_density_stats_matches_jax(rng):
    cap = 40
    g_us = rng.normal(size=(cap, 2)).astype(np.float32)
    visible = rng.random(cap) < 0.6
    acc0 = rng.uniform(size=cap).astype(np.float32)
    cnt0 = rng.integers(0, 5, size=cap).astype(np.int32)
    want = jax_update_stats(JaxDensityStats(jnp.asarray(acc0), jnp.asarray(cnt0)),
                            jnp.asarray(g_us), jnp.asarray(visible))
    stats = density_stats_from_numpy(acc0, cnt0, device="cpu")
    update_density_stats(stats, torch.from_numpy(g_us), torch.from_numpy(visible))
    np.testing.assert_allclose(stats.grad_accum.numpy(), np.asarray(want.grad_accum),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(stats.cunt.numpy(), np.asarray(want.cunt))
    assert stats.cunt.dtype == torch.int32
    fresh = density_stats_init(cap, "cpu")
    assert float(fresh.grad_accum.sum()) == 0 and int(fresh.cunt.sum()) == 0


def test_densify_and_prune_matches_jax():
    """Prune, clone and split with the JAX split noise handed over; the
    capacity is too small for every candidate, so some are dropped."""
    rng = np.random.default_rng(3)
    n, cap = 24, 26
    # odd gaussians small (clone), even ones large (split), two transparent (prune)
    log_scales = np.where(np.arange(n)[:, None] % 2, -6.0, -3.5) + rng.normal(size=(n, 3)) * 0.3
    alphas = rng.uniform(0.1, 0.9, size=n)
    alphas[[2, 5]] = 0.002
    jpool = jax_pool_from_arrays(rng.normal(size=(n, 3)), rng.normal(size=(n, 4)),
                                 np.exp(log_scales), alphas, rng.normal(size=(n, 3)),
                                 capacity=cap)
    js = jax_adam_init(jpool.params())
    js = dataclasses.replace(js, mu={k: v + 1.0 for k, v in js.mu.items()},
                             nu={k: v + 2.0 for k, v in js.nu.items()})
    acc = rng.uniform(size=cap).astype(np.float32) * 2e-6
    cnt = rng.integers(0, 3, size=cap).astype(np.int32)
    key = jax.random.PRNGKey(4)
    cfg, jcfg = TrainConfig(), JaxTrainConfig()
    new_jpool, new_js, new_jstats, jrep = jax_densify(
        jpool, js, JaxDensityStats(jnp.asarray(acc), jnp.asarray(cnt)), key, 1.0, jcfg)
    assert int(jrep["n_pruned"]) > 0 and int(jrep["n_cloned"]) > 0
    assert int(jrep["n_split"]) > 0 and int(jrep["n_dropped"]) > 0

    pool = pool_from_numpy(_leaves(jpool), device="cpu")
    state = adam_state_from_numpy(*_jax_state(js), device="cpu")
    stats = density_stats_from_numpy(acc, cnt, device="cpu")
    noise = torch.from_numpy(np.array(jax.random.normal(key, (cap, 3))))
    rep = densify_and_prune(pool, state, stats, noise, 1.0, cfg)
    for k in jrep:
        assert int(rep[k]) == int(jrep[k]), k
    for k, v in _leaves(new_jpool).items():
        np.testing.assert_allclose(getattr(pool, k).detach().numpy(), v, atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    for k in GROUPS:
        np.testing.assert_array_equal(state.mu[k].numpy(), np.asarray(new_js.mu[k]), err_msg=k)
        np.testing.assert_array_equal(state.nu[k].numpy(), np.asarray(new_js.nu[k]), err_msg=k)
    assert float(stats.grad_accum.abs().sum()) == 0 and int(stats.cunt.sum()) == 0


def test_split_noise_comes_from_the_generator():
    a = split_noise(16, torch.Generator().manual_seed(5), "cpu")
    b = split_noise(16, torch.Generator().manual_seed(5), "cpu")
    assert a.shape == (16, 3) and a.dtype == torch.float32 and torch.equal(a, b)


def test_reset_alpha_matches_jax():
    _, jpool, _ = _scene()
    js = jax_adam_init(jpool.params())
    js = dataclasses.replace(js, mu={k: v + 3.0 for k, v in js.mu.items()})
    new_jpool, new_js = jax_reset_alpha(jpool, js, JaxTrainConfig())
    pool = pool_from_numpy(_leaves(jpool), device="cpu")
    state = adam_state_from_numpy(*_jax_state(js), device="cpu")
    reset_alpha(pool, state, TrainConfig())
    np.testing.assert_array_equal(pool.alphas_raw.detach().numpy(),
                                  np.asarray(new_jpool.alphas_raw))
    assert float(state.mu["alphas_raw"].abs().sum()) == 0.0
    np.testing.assert_array_equal(state.mu["pws"].numpy(), np.asarray(new_js.mu["pws"]))


def test_train_step_matches_jax():
    """One make_train_step of each package from one pool, Adam state (count
    1, non-zero moments, from one JAX step) and stats, on the tiled backend.

    Tolerances: the loss within rel 1e-5 (float32 sums in another order);
    the gradient groups, through the moments, within the kernel-vs-AD
    tolerance of tests/test_pallas.py scaled by (1 - b1) for mu; each
    parameter within 1e-3 of its group's learning rate (an Adam step moves a
    parameter by at most about lr, and gradients that differ by 5e-4
    relative move that step by about as much)."""
    s, jpool, gts = _scene()
    jcfg = JaxTrainConfig(backend="tiled", max_patches=4096)
    cfg = TrainConfig(backend="tiled", max_patches=4096)
    jstep = jax_make_train_step(jcfg, SCENE_SIZE, 100)
    jcam = s["cameras"][1]
    jstats = JaxDensityStats(jnp.zeros(jpool.capacity), jnp.zeros(jpool.capacity, jnp.int32))
    jpool, js, jstats, _, _ = jstep(jpool, jax_adam_init(jpool.params()), jstats,
                                    s["cameras"][0], jnp.asarray(gts[0]))
    pool = pool_from_numpy(_leaves(jpool), device="cpu")
    state = adam_state_from_numpy(*_jax_state(js), device="cpu")
    stats = density_stats_from_numpy(np.asarray(jstats.grad_accum), np.asarray(jstats.cunt),
                                     device="cpu")
    jpool2, js2, jstats2, jloss, jbinfo = jstep(jpool, js, jstats, jcam, jnp.asarray(gts[1]))
    step = make_train_step(cfg, SCENE_SIZE, 100, device="cpu")
    loss, binfo = step(pool, state, stats, camera_from_numpy(jcam), torch.from_numpy(gts[1]))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("obs", "dropped"):
        assert int(binfo[k]) == int(jbinfo[k]), k
    assert int(binfo["dropped"]) == 0 and state.count == int(js2.count) == 2
    lrs = {k: f(1) for k, f in make_lr_fns(cfg, SCENE_SIZE, 100).items()}
    for k in GROUPS:
        mu, jmu = state.mu[k].numpy(), np.asarray(js2.mu[k])
        np.testing.assert_allclose(mu, jmu, atol=0.1 * 5e-4 * max(1.0, np.abs(jmu).max() / 0.1),
                                   err_msg=f"mu {k}")
        nu, jnu = state.nu[k].numpy(), np.asarray(js2.nu[k])
        np.testing.assert_allclose(nu, jnu, atol=1e-3 * max(1e-12, np.abs(jnu).max()),
                                   err_msg=f"nu {k}")
        np.testing.assert_allclose(getattr(pool, k).detach().numpy(), np.asarray(jpool2.params()[k]),
                                   atol=1e-3 * lrs[k], rtol=0, err_msg=k)
    np.testing.assert_array_equal(stats.cunt.numpy(), np.asarray(jstats2.cunt))
    np.testing.assert_allclose(stats.grad_accum.numpy(), np.asarray(jstats2.grad_accum),
                               atol=5e-4 * max(1.0, float(np.abs(jstats2.grad_accum).max())))


def test_a_few_cpu_steps_lower_the_loss():
    s, jpool, gts = _scene(seed=1)
    pool = pool_from_numpy(_leaves(jpool), device="cpu")
    state = adam_init(pool.params())
    stats = density_stats_init(pool.capacity, "cpu")
    step = make_train_step(TrainConfig(max_patches=4096), SCENE_SIZE, 100, device="cpu")
    cams = [camera_from_numpy(c) for c in s["cameras"]]
    losses = [float(step(pool, state, stats, cams[i % 2], torch.from_numpy(gts[i % 2]))[0])
              for i in range(8)]
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    assert int(stats.cunt.max()) == 8


def test_train_step_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(TrainConfig(), SCENE_SIZE, 100)
