"""PyTorch port: checkpoint and resume, and the save side of the Gaussian
file I/O. The port's checkpoints round-trip and load in the JAX package,
JAX checkpoints load in the port, a resumed step and a resumed ``train`` are
bit-equal to the uninterrupted ones (the port of tests/test_checkpoint.py),
and .ply / .npy files written by either package load in the other."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from easygaussiansplatting_tpu.data import gau_io as jax_gau_io
from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu.models.gaussians import pool_from_arrays as jax_pool_from_arrays
from easygaussiansplatting_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from easygaussiansplatting_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from easygaussiansplatting_tpu.train.density import DensityStats as JaxDensityStats
from easygaussiansplatting_tpu.train.optimizer import AdamState as JaxAdamState
from easygaussiansplatting_tpu_torch.data import gau_io
from easygaussiansplatting_tpu_torch.data.synthetic import render_gt_images
from easygaussiansplatting_tpu_torch.models.convert import generator_from_jax_key
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS, pool_from_arrays
from easygaussiansplatting_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import density_stats_init
from easygaussiansplatting_tpu_torch.train.loop import make_train_step, train
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init

torch.set_num_threads(2)

CONFIG = TrainConfig(backend="tiled", max_patches=2**12)
FIELDS = GROUPS + ("alive",)


def _state(seed=5, cap=64):
    """A pool with non-trivial Adam state and stats (two steps taken)."""
    s = make_synthetic_scene(seed=seed, n_gaussians=40, n_cams=2, width=32, height=32)
    pool = pool_from_arrays(s["pws"], s["rots"], s["scales"], s["alphas"], s["shs"],
                            capacity=cap, device="cpu")
    gts = render_gt_images(s, CONFIG, device="cpu")
    step = make_train_step(CONFIG, s["scene_size"], 10, device="cpu")
    adam, stats = adam_init(pool.params()), density_stats_init(pool.capacity, "cpu")
    for i in range(2):
        step(pool, adam, stats, s["cameras"][i], gts[i])
    return s, pool, adam, stats, gts, step


def _assert_state_equal(a, b):
    (pool, adam, stats), (pool2, adam2, stats2) = a, b
    for f in FIELDS:
        assert torch.equal(getattr(pool, f), getattr(pool2, f)), f
    assert adam.count == adam2.count
    for f in GROUPS:
        assert torch.equal(adam.mu[f], adam2.mu[f]) and torch.equal(adam.nu[f], adam2.nu[f]), f
    assert torch.equal(stats.grad_accum, stats2.grad_accum)
    assert torch.equal(stats.cunt, stats2.cunt)


def test_checkpoint_round_trip(tmp_path):
    _, pool, adam, stats, _, _ = _state()
    gen = torch.Generator().manual_seed(11)
    torch.randn(5, generator=gen)  # a generator part-way through its stream
    save_checkpoint(tmp_path / "ck.npz", pool, adam, stats, epoch=7, generator=gen)
    pool2, adam2, stats2, epoch, gen2 = load_checkpoint(tmp_path / "ck.npz", device="cpu")
    assert epoch == 7 and adam2.count == 2
    _assert_state_equal((pool, adam, stats), (pool2, adam2, stats2))
    assert torch.equal(torch.randn(8, generator=gen), torch.randn(8, generator=gen2))
    save_checkpoint(tmp_path / "nogen.npz", pool, adam, stats, epoch=1)
    assert load_checkpoint(tmp_path / "nogen.npz", device="cpu")[4] is None


def test_resumed_step_is_bit_exact(tmp_path):
    s, pool, adam, stats, gts, step = _state()
    save_checkpoint(tmp_path / "ck.npz", pool, adam, stats, epoch=2)
    cam = s["cameras"][0]
    loss3, _ = step(pool, adam, stats, cam, gts[0])
    rpool, radam, rstats, _, _ = load_checkpoint(tmp_path / "ck.npz", device="cpu")
    qloss, _ = step(rpool, radam, rstats, cam, gts[0])
    assert float(qloss) == float(loss3)
    _assert_state_equal((pool, adam, stats), (rpool, radam, rstats))


def test_port_checkpoint_loads_in_jax(tmp_path):
    _, pool, adam, stats, _, _ = _state()
    save_checkpoint(tmp_path / "ck.npz", pool, adam, stats, epoch=3,
                    generator=torch.Generator().manual_seed(1))
    jpool, jadam, jstats, epoch, key = jax_load_checkpoint(tmp_path / "ck.npz")
    assert epoch == 3 and key is None and int(jadam.count) == 2
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jpool, f)), getattr(pool, f).detach())
    for f in GROUPS:
        np.testing.assert_array_equal(np.asarray(jadam.mu[f]), adam.mu[f])
        np.testing.assert_array_equal(np.asarray(jadam.nu[f]), adam.nu[f])
    np.testing.assert_array_equal(np.asarray(jstats.grad_accum), stats.grad_accum)
    np.testing.assert_array_equal(np.asarray(jstats.cunt), stats.cunt)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(3)
    n, cap = 20, 32
    jpool = jax_pool_from_arrays(rng.normal(size=(n, 3)), rng.normal(size=(n, 4)),
                                 np.exp(rng.normal(size=(n, 3))), rng.uniform(size=n),
                                 rng.normal(size=(n, 48)), capacity=cap)
    params = jpool.params()
    jadam = JaxAdamState(count=jnp.int32(9),
                         mu={k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
                             for k, v in params.items()},
                         nu={k: jnp.asarray(rng.uniform(size=v.shape), jnp.float32)
                             for k, v in params.items()})
    jstats = JaxDensityStats(jnp.asarray(rng.uniform(size=cap), jnp.float32),
                             jnp.asarray(rng.integers(0, 9, size=cap), jnp.int32))
    key = jax.random.PRNGKey(42)
    jax_save_checkpoint(tmp_path / "jck.npz", jpool, jadam, jstats, epoch=4, key=key)
    pool, adam, stats, epoch, gen = load_checkpoint(tmp_path / "jck.npz", device="cpu")
    assert epoch == 4 and adam.count == 9 and pool.capacity == cap
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pool, f).detach().numpy(),
                                      np.asarray(getattr(jpool, f)))
    for f in GROUPS:
        np.testing.assert_array_equal(adam.mu[f].numpy(), np.asarray(jadam.mu[f]))
        np.testing.assert_array_equal(adam.nu[f].numpy(), np.asarray(jadam.nu[f]))
    np.testing.assert_array_equal(stats.grad_accum.numpy(), np.asarray(jstats.grad_accum))
    np.testing.assert_array_equal(stats.cunt.numpy(), np.asarray(jstats.cunt))
    # the JAX key seeds the generator
    want = generator_from_jax_key(np.asarray(jax.random.key_data(key)))
    assert torch.equal(torch.randn(6, generator=gen), torch.randn(6, generator=want))


def _generator_copy(gen):
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


def test_train_resumed_from_a_checkpoint_is_bit_equal_to_train_continued_in_memory(tmp_path):
    """A 3-epoch run saves a checkpoint and copies its state in memory at
    epoch 1; train(start_epoch=1) from each is then bit-equal, through a
    densify at epoch 2 that draws from the restored generator."""
    s = make_synthetic_scene(seed=1, n_gaussians=60, n_cams=2, width=32, height=32)
    cfg = TrainConfig(backend="tiled", max_patches=2**12, epochs=3, densify_every_epochs=2,
                      reset_alpha_every_epochs=100)
    gts = render_gt_images(s, cfg, device="cpu")
    pool = pool_from_arrays(s["pws"] + 0.02, s["rots"], s["scales"], s["alphas"], s["shs"],
                            capacity=80, device="cpu")
    kept = {}

    def at_epoch_1(e, pool, adam, stats, gen):
        if e == 1:
            save_checkpoint(tmp_path / "ck.npz", pool, adam, stats, epoch=e, generator=gen)
            kept["state"] = copy.deepcopy((pool, adam, stats))
            kept["gen"] = _generator_copy(gen)

    quiet = dict(log_fn=lambda *_: None, eval_every=100, seed=3)
    train(pool, s["cameras"], gts, cfg, s["scene_size"], epoch_cb=at_epoch_1, **quiet)
    rpool, radam, rstats, epoch, rgen = load_checkpoint(tmp_path / "ck.npz", device="cpu")
    assert epoch == 1
    mpool, madam, mstats = kept["state"]
    _, rh = train(rpool, s["cameras"], gts, cfg, s["scene_size"], adam_state=radam,
                  stats=rstats, start_epoch=1, generator=rgen, **quiet)
    _, mh = train(mpool, s["cameras"], gts, cfg, s["scene_size"], adam_state=madam,
                  stats=mstats, start_epoch=1, generator=kept["gen"], **quiet)
    assert rh["loss"] == mh["loss"] and len(rh["loss"]) == 2
    assert rh["n_alive"] == mh["n_alive"] and rh["n_alive"][0] > 60  # densify added some
    _assert_state_equal((rpool, radam, rstats), (mpool, madam, mstats))


def _records(seed=0, n=30, sh_dim=48):
    rng = np.random.default_rng(seed)
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return gau_io.arrays_to_recarray(rng.normal(size=(n, 3)), rots,
                                     np.exp(rng.normal(size=(n, 3)) - 2), rng.uniform(size=n),
                                     rng.normal(size=(n, sh_dim)))


def test_ply_files_are_byte_identical_and_load_both_ways(tmp_path):
    for sh_dim in (3, 48):
        rec = _records(sh_dim=sh_dim)
        gau_io.save_ply(tmp_path / "port.ply", rec)
        jax_gau_io.save_ply(tmp_path / "jax.ply", rec)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
        a = gau_io.load_gs(tmp_path / "jax.ply")
        b = jax_gau_io.load_gs(tmp_path / "port.ply")
        for f in ("pw", "rot", "scale", "alpha", "sh"):
            np.testing.assert_array_equal(a[f], b[f])
            np.testing.assert_allclose(a[f], rec[f], rtol=1e-5, atol=1e-6)


def test_save_pool_and_load_pool_both_ways(tmp_path):
    """The port's pool saved as .npy and .ply loads in JAX, the JAX pool's
    in the port: equal records."""
    rec = _records(seed=1, n=24)
    a = gau_io.recarray_to_arrays(rec)
    pool = pool_from_arrays(a["pws"], a["rots"], a["scales"], a["alphas"], a["shs"],
                            capacity=32, device="cpu")
    jpool = jax_pool_from_arrays(a["pws"], a["rots"], a["scales"], a["alphas"], a["shs"],
                                 capacity=32)
    for ext in (".npy", ".ply"):
        gau_io.save_pool(tmp_path / f"port{ext}", pool)
        jax_gau_io.save_pool(tmp_path / f"jax{ext}", jpool)
        got = jax_gau_io.load_gs(tmp_path / f"port{ext}")
        want = gau_io.load_gs(tmp_path / f"jax{ext}")
        assert len(got) == len(want) == 24
        for f in ("pw", "rot", "scale", "alpha", "sh"):
            np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=1e-7, err_msg=f)
        loaded = gau_io.load_pool(tmp_path / f"jax{ext}", capacity=40, device="cpu")
        assert loaded.capacity == 40 and int(loaded.n_alive()) == 24
        jloaded = jax_gau_io.load_pool(tmp_path / f"port{ext}", capacity=40)
        np.testing.assert_allclose(np.asarray(jloaded.pws), loaded.pws.detach().numpy())
