"""PyTorch port: the multi-device layer on torch.distributed against the JAX
package's parallel/ on conftest's 8-device virtual mesh.

The port runs in gloo ranks on the CPU: one group of 2 ranks and one of 4,
started together from this file (``python tests/test_torch_parallel.py
RANK WORLD PORT IN.npz OUT.npz``, as tests/multihost_worker.py is for JAX),
each rank running every case of its world size on the inputs the pytest
process wrote and rank 0 writing the results; the JAX side runs in the
pytest process meanwhile. Both start from one numpy-seeded scene and one
JAX training state (carried across by models/convert.py), and the split
noise of train_sharded is JAX's key sequence, which the ranks read.

Cases: make_mesh's shapes and errors, process_batch_rows and
make_multihost_mesh; the batched step on (2, 1), (1, 2) and (2, 2); the
banded step on 2 and 4 bands; the banded render on 2 and 4 bands, a tall
image among them; train_sharded batched and banded with a densify; a
banded run whose band budget overflows; the bytes of the collectives.
"""

import json
import os
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from easygaussiansplatting_tpu_torch.models.convert import (  # noqa: E402
    adam_state_from_numpy,
    density_stats_from_numpy,
    pool_from_numpy,
)
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS  # noqa: E402
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import TABLE_COLS  # noqa: E402
from easygaussiansplatting_tpu_torch.ops.rasterize import render  # noqa: E402
from easygaussiansplatting_tpu_torch.parallel import collectives  # noqa: E402
from easygaussiansplatting_tpu_torch.parallel import loop as ploop  # noqa: E402
from easygaussiansplatting_tpu_torch.parallel.distributed import (  # noqa: E402
    fetch_to_host,
    free_port,
    init_distributed,
    launch_ranks,
    make_multihost_mesh,
    process_batch_rows,
)
from easygaussiansplatting_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape  # noqa: E402
from easygaussiansplatting_tpu_torch.parallel.train import (  # noqa: E402
    make_banded_train_step,
    make_sharded_render,
    make_sharded_train_step,
    shard_batch,
    shard_pool,
    stack_cameras,
)
from easygaussiansplatting_tpu_torch.train.config import TrainConfig  # noqa: E402
from easygaussiansplatting_tpu_torch.train.loop import make_train_step  # noqa: E402

POOL_FIELDS = GROUPS + ("alive",)
# JAX's test_parallel.py CONFIG (Pallas, interpret mode on the CPU); the
# port takes its plain path. Budgets for which JAX's keff-aligned band
# shares and the port's agree (multiples of 128 for 2 and 4 bands).
MAX_PATCHES = 2**12
TALL_MAX_PATCHES = 2**13
STEP_SCENE = dict(seed=3, n_gaussians=48, n_cams=4, width=32, height=32)
STEP_CAP = 64
BAND_SCENE = dict(seed=13, n_gaussians=192, n_cams=2, width=48, height=112)
TALL_SCENE = dict(seed=11, n_gaussians=256, n_cams=1, width=48, height=112)
LOOP_SCENE = dict(seed=9, n_gaussians=48, n_cams=4, width=32, height=32)
LOOP_CAP = 96
LOOP_CFG = dict(densify_every_epochs=2, reset_alpha_every_epochs=3, adaptive_budget=False)
MAX_STEPS = 50
SHARDED_SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
OVERFLOW_MAX_PATCHES = 64
RANK_TIMEOUT = 240


def _cfg(max_patches=MAX_PATCHES, **kw):
    return TrainConfig(backend="tiled", max_patches=max_patches, **kw)


def _perturbed(scene, seed):
    rng = np.random.default_rng(seed)
    n = len(scene["pws"])
    alphas = np.clip(scene["alphas"] + rng.normal(size=n) * 0.1, 0.05, 0.95)
    return (scene["pws"] + rng.normal(scale=0.05, size=scene["pws"].shape), scene["rots"],
            scene["scales"], alphas, scene["shs"] * 0.5)


def _gts(scene, max_patches=MAX_PATCHES):
    args = [scene[k] for k in ("pws", "shs", "alphas", "scales", "rots")]
    return np.stack([render(*args, c, max_patches=max_patches, need_grads=False,
                            device="cpu")[0].numpy() for c in scene["cameras"]])


# ----------------------------------------------------------------- the ranks

def _state(z, prefix):
    pool = pool_from_numpy({k: z[f"{prefix}/pool/{k}"] for k in POOL_FIELDS}, "cpu")
    adam = adam_state_from_numpy(int(z[f"{prefix}/count"]),
                                 {k: z[f"{prefix}/mu/{k}"] for k in GROUPS},
                                 {k: z[f"{prefix}/nu/{k}"] for k in GROUPS}, "cpu")
    stats = density_stats_from_numpy(z[f"{prefix}/grad_accum"], z[f"{prefix}/cunt"], "cpu")
    return pool, adam, stats


def _put_state(res, prefix, pool, stats):
    for k in POOL_FIELDS:
        res[f"{prefix}/{k}"] = getattr(pool, k).detach().numpy()
    res[f"{prefix}/grad_accum"] = stats.grad_accum.numpy()
    res[f"{prefix}/cunt"] = stats.cunt.numpy()


def _bytes(res, prefix):
    for (op, axis, tag), n in collectives.BYTES.items():
        res[f"{prefix}/bytes/{op}/{axis}/{tag}"] = np.int64(n)
    collectives.BYTES.clear()


def _mesh_checks(world):
    """Shapes of make_mesh and make_multihost_mesh on this group, and their
    errors, as one dict of strings."""
    out = {}
    for data in (None, 1, world):
        out[f"make_mesh/{data}"] = str(tuple(make_mesh(data=data).shape.values()))
    for bad in (dict(n_devices=world * 2), dict(data=3)):
        try:
            make_mesh(**bad)
            out[f"error/{bad}"] = "none"
        except ValueError as e:
            out[f"error/{bad}"] = str(e)
    rank = torch.distributed.get_rank()
    out["multihost/one host"] = str(tuple(make_multihost_mesh().shape.values()))
    per_rank = make_multihost_mesh(host=f"h{rank}")
    out["multihost/host a rank"] = str((tuple(per_rank.shape.values()), per_rank.hosts))
    try:
        make_multihost_mesh(data=3)
        out["multihost/error"] = "none"
    except ValueError as e:
        out["multihost/error"] = str(e)
    return out


def _sharded_case(z, res, shape):
    scene = make_synthetic_scene(**STEP_SCENE)
    mesh = make_mesh(data=shape[0])
    assert tuple(mesh.shape.values()) == shape
    pool, adam, stats = shard_pool(mesh, *_state(z, "step"))
    cams = shard_batch(mesh, stack_cameras(scene["cameras"][:2]))
    gts = shard_batch(mesh, torch.from_numpy(z["step/gt"][:2]))
    step = make_sharded_train_step(mesh, _cfg(), scene["scene_size"], MAX_STEPS)
    collectives.BYTES.clear()
    loss, binfo = step(pool, adam, stats, cams, gts)
    _bytes(res, f"sharded{shape}")
    full_pool, full_stats = fetch_to_host(mesh, (pool, stats))
    res[f"sharded{shape}/loss"] = float(loss)
    res[f"sharded{shape}/dropped"] = int(binfo["dropped"])
    _put_state(res, f"sharded{shape}", full_pool, full_stats)


def _banded_case(z, res, world):
    scene = make_synthetic_scene(**BAND_SCENE)
    mesh = make_mesh()
    pool, adam, stats = shard_pool(mesh, *_state(z, "band"))
    step = make_banded_train_step(mesh, _cfg(TALL_MAX_PATCHES), scene["scene_size"], MAX_STEPS)
    collectives.BYTES.clear()
    loss, binfo = step(pool, adam, stats, scene["cameras"][0], torch.from_numpy(z["band/gt"]))
    _bytes(res, f"banded{world}")
    full_pool, full_stats = fetch_to_host(mesh, (pool, stats))
    res[f"banded{world}/loss"] = float(loss)
    res[f"banded{world}/dropped"] = int(binfo["dropped"])
    _put_state(res, f"banded{world}", full_pool, full_stats)


def _render_case(z, res, world):
    mesh = make_mesh()
    for name, scene_kw, mp in (("render", STEP_SCENE, MAX_PATCHES),
                               ("tall", TALL_SCENE, TALL_MAX_PATCHES)):
        scene = make_synthetic_scene(**scene_kw)
        pool = shard_pool(mesh, pool_from_numpy({k: z[f"{name}/pool/{k}"]
                                                 for k in POOL_FIELDS}, "cpu"))
        for banded in (True, False):
            img, aux = make_sharded_render(mesh, _cfg(mp), tile_sharded=banded,
                                           with_aux=True)(pool, scene["cameras"][0])
            res[f"{name}{world}/{banded}/image"] = img.numpy()
            res[f"{name}{world}/{banded}/n_dropped"] = int(aux["n_dropped"])


def _loop_case(z, res, world, banded, overflow=False):
    scene = make_synthetic_scene(**LOOP_SCENE)
    mesh = make_mesh()
    noise = [torch.from_numpy(a) for a in z["loop/noise"]]
    ploop.split_noise = lambda capacity, generator, device: noise.pop(0)
    pool = pool_from_numpy({k: z[f"loop/pool/{k}"] for k in POOL_FIELDS}, "cpu")
    epochs = 2 if overflow else (3 if banded else 4)
    mp = OVERFLOW_MAX_PATCHES if overflow else MAX_PATCHES
    logs = []
    pool, hist = ploop.train_sharded(pool, scene["cameras"], list(z["loop/gt"]),
                                     _cfg(mp, epochs=epochs, **LOOP_CFG), scene["scene_size"],
                                     mesh, batch=None if banded else 2, banded=banded,
                                     log_fn=logs.append, eval_every=2)
    name = f"loop{world}/{'overflow' if overflow else banded}"
    res[f"{name}/history"] = json.dumps({k: hist[k] for k in hist if k != "epoch_time"})
    res[f"{name}/logs"] = json.dumps(logs)
    res[f"{name}/alive"] = pool.alive.numpy()


def _overflow_step(z, res, world):
    """One banded step whose band budget is far too small."""
    scene = make_synthetic_scene(**BAND_SCENE)
    mesh = make_mesh()
    pool, adam, stats = shard_pool(mesh, *_state(z, "band"))
    step = make_banded_train_step(mesh, _cfg(OVERFLOW_MAX_PATCHES), scene["scene_size"],
                                  MAX_STEPS)
    loss, binfo = step(pool, adam, stats, scene["cameras"][0], torch.from_numpy(z["band/gt"]))
    res[f"overflow{world}/dropped"] = int(binfo["dropped"])
    res[f"overflow{world}/loss"] = float(loss)


def _worker(rank, world, port, inp, out):
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", world, rank, device="cpu", timeout_s=RANK_TIMEOUT)
    z = dict(np.load(inp))
    res = {f"mesh/{k}": v for k, v in _mesh_checks(world).items()}
    for shape in SHARDED_SHAPES[world]:
        _sharded_case(z, res, shape)
    _banded_case(z, res, world)
    _render_case(z, res, world)
    if world == 2:
        _loop_case(z, res, world, banded=True)
        _loop_case(z, res, world, banded=True, overflow=True)
        _overflow_step(z, res, world)
    else:
        _loop_case(z, res, world, banded=False)
    if rank == 0:
        np.savez(out, **res)
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "world": world, "cases": len(res)}))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    sys.exit(0)


# ---------------------------------------------------------- the pytest side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene as jax_scene  # noqa: E402
from easygaussiansplatting_tpu.models.gaussians import GaussianPool as JaxGaussianPool  # noqa: E402
from easygaussiansplatting_tpu.models.gaussians import pool_from_arrays as jax_pool  # noqa: E402
from easygaussiansplatting_tpu.parallel import mesh as jax_mesh_mod  # noqa: E402
from easygaussiansplatting_tpu.parallel.distributed import (  # noqa: E402
    process_batch_rows as jax_batch_rows,
)
from easygaussiansplatting_tpu.parallel.loop import train_sharded as jax_train_sharded  # noqa: E402
from easygaussiansplatting_tpu.parallel.train import (  # noqa: E402
    make_banded_train_step as jax_banded_step,
    make_sharded_render as jax_sharded_render,
    make_sharded_train_step as jax_sharded_step,
    shard_batch as jax_shard_batch,
    shard_pool as jax_shard_pool,
    stack_cameras as jax_stack_cameras,
)
from easygaussiansplatting_tpu.train.config import TrainConfig as JaxTrainConfig  # noqa: E402
from easygaussiansplatting_tpu.train.density import DensityStats as JaxDensityStats  # noqa: E402
from easygaussiansplatting_tpu.train.optimizer import AdamState as JaxAdamState  # noqa: E402
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy  # noqa: E402
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays  # noqa: E402
from easygaussiansplatting_tpu_torch.train.density import density_stats_init  # noqa: E402
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init, make_lr_fns  # noqa: E402

def _jcfg(max_patches=MAX_PATCHES, **kw):
    return JaxTrainConfig(backend="pallas", tile=16, max_patches=max_patches, k_chunk=128,
                          **kw)


def _leaves(obj, names):
    return {k: np.asarray(getattr(obj, k)) for k in names}


def _first_step(inp, prefix, scene_kw, cap, max_patches, batch):
    """A pool started from the scene with perturbed positions, opacities and
    colours, after one batched step of the port on one rank, written into
    ``inp`` under ``prefix``; a start state with non-zero Adam moments (a
    first Adam step moves every parameter with a non-zero gradient by its
    full learning rate, whatever the gradient's size). Returns (JAX's
    scene, the ground truth, the state as JAX's pool, Adam state, stats)."""
    s = make_synthetic_scene(**scene_kw)
    pool = pool_from_arrays(*_perturbed(s, scene_kw["seed"] + 10), capacity=cap, device="cpu")
    gts = _gts(s, max_patches)
    adam, stats = adam_init(pool.params()), density_stats_init(cap, "cpu")
    step = make_sharded_train_step(make_mesh(), _cfg(max_patches), s["scene_size"], MAX_STEPS)
    step(pool, adam, stats, s["cameras"][batch:2 * batch], torch.from_numpy(gts[batch:2 * batch]))
    res = {}
    _put_state(res, prefix, pool, stats)
    inp.update({f"{prefix}/pool/{k}": res[f"{prefix}/{k}"] for k in POOL_FIELDS})
    inp.update({f"{prefix}/{k}": res[f"{prefix}/{k}"] for k in ("grad_accum", "cunt")})
    inp[f"{prefix}/count"] = np.asarray(adam.count)
    for k in GROUPS:
        inp[f"{prefix}/mu/{k}"] = adam.mu[k].numpy()
        inp[f"{prefix}/nu/{k}"] = adam.nu[k].numpy()
    jpool = JaxGaussianPool(**{k: jnp.asarray(inp[f"{prefix}/pool/{k}"]) for k in POOL_FIELDS})
    js = JaxAdamState(count=jnp.asarray(adam.count, jnp.int32),
                      mu={k: jnp.asarray(inp[f"{prefix}/mu/{k}"]) for k in GROUPS},
                      nu={k: jnp.asarray(inp[f"{prefix}/nu/{k}"]) for k in GROUPS})
    jst = JaxDensityStats(jnp.asarray(inp[f"{prefix}/grad_accum"]),
                          jnp.asarray(inp[f"{prefix}/cunt"]))
    return jax_scene(**scene_kw), gts, (jpool, js, jst)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes the inputs, starts both groups of ranks, and meanwhile runs
    the JAX side; returns (the ranks' results by world size, JAX's results,
    JAX's inputs, the inputs written)."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp, jx = {}, {}
    s_step, gts, (jp, js, jst) = _first_step(inp, "step", STEP_SCENE, STEP_CAP, MAX_PATCHES, 2)
    inp["step/gt"] = gts
    jx["step"] = (s_step, gts, jp, js, jst)
    s_band, gts_b, (bp, bs, bst) = _first_step(inp, "band", BAND_SCENE, 192, TALL_MAX_PATCHES,
                                               1)
    inp["band/gt"] = gts_b[0]
    jx["band"] = (s_band, gts_b, bp, bs, bst)
    jx["render"] = jx["step"]
    s_tall = jax_scene(**TALL_SCENE)
    tp = jax_pool(s_tall["pws"], s_tall["rots"], s_tall["scales"], s_tall["alphas"],
                  s_tall["shs"], capacity=256)
    jx["tall"] = (s_tall, None, tp, None, None)
    for name in ("render", "tall"):
        for k, v in _leaves(jx[name][2], POOL_FIELDS).items():
            inp[f"{name}/pool/{k}"] = v
    s_loop = jax_scene(**LOOP_SCENE)
    lp = jax_pool(*_perturbed(s_loop, 1), capacity=LOOP_CAP)
    inp["loop/gt"] = _gts(make_synthetic_scene(**LOOP_SCENE))
    for k, v in _leaves(lp, POOL_FIELDS).items():
        inp[f"loop/pool/{k}"] = v
    key, noise = jax.random.PRNGKey(0), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (LOOP_CAP, 3))))
    inp["loop/noise"] = np.stack(noise)
    jx["loop"] = (s_loop, inp["loop/gt"], lp)
    np.savez(tmp / "in.npz", **inp)

    outs = {w: tmp / f"out{w}.npz" for w in (2, 4)}
    errors = []

    def group(world):
        port = free_port()
        try:
            launch_ranks(lambda r: [sys.executable, __file__, str(r), str(world), str(port),
                                    str(tmp / "in.npz"), str(outs[world])],
                         world, RANK_TIMEOUT, env={**os.environ, "OMP_NUM_THREADS": "1"},
                         cwd=ROOT)
        except RuntimeError as e:  # raised below, in the fixture's thread
            errors.append(e)

    threads = [threading.Thread(target=group, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    jres = _jax_side(jx)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    port = {w: dict(np.load(outs[w])) for w in (2, 4)}
    return port, jres, jx, inp


def _jax_side(jx):
    """JAX's results of every case the ranks run."""
    out = {}
    s, gts, jp, js, jst = jx["step"]
    bcam = jax_stack_cameras(s["cameras"][:2])
    for shape in SHARDED_SHAPES[2] + SHARDED_SHAPES[4]:
        mesh = jax_mesh_mod.make_mesh(shape[0] * shape[1], data=shape[0])
        step = jax_sharded_step(mesh, _jcfg(), s["scene_size"], MAX_STEPS)
        p, a, st = jax_shard_pool(mesh, jp, js, jst)
        p, a, st, loss = step(p, a, st, jax_shard_batch(mesh, bcam),
                              jax_shard_batch(mesh, jnp.asarray(gts[:2])))
        out[f"sharded{shape}"] = (float(loss), p, a, st)
    s, gts, bp, bs, bst = jx["band"]
    for n in (2, 4):
        mesh = jax_mesh_mod.make_mesh(n)
        step = jax_banded_step(mesh, _jcfg(TALL_MAX_PATCHES), s["scene_size"], MAX_STEPS)
        p, a, st = jax_shard_pool(mesh, bp, bs, bst)
        p, a, st, loss = step(p, a, st, s["cameras"][0], jnp.asarray(gts[0]))
        out[f"banded{n}"] = (float(loss), p, a, st)
    for name, mp in (("render", MAX_PATCHES), ("tall", TALL_MAX_PATCHES)):
        s, pool = jx[name][0], jx[name][2]
        for n in (2, 4):
            mesh = jax_mesh_mod.make_mesh(n)
            img, aux = jax_sharded_render(mesh, _jcfg(mp), tile_sharded=True, with_aux=True)(
                jax_shard_pool(mesh, pool), s["cameras"][0])
            out[f"{name}{n}"] = (np.asarray(img), int(aux["n_dropped"]))
    s, gts, lp = jx["loop"]
    for n, banded, epochs in ((2, True, 3), (4, False, 4)):
        logs = []
        pool, hist = jax_train_sharded(
            lp, s["cameras"], [jnp.asarray(g) for g in gts],
            _jcfg(epochs=epochs, **LOOP_CFG), s["scene_size"], jax_mesh_mod.make_mesh(n),
            batch=None if banded else 2, banded=banded, log_fn=logs.append, eval_every=2)
        out[f"loop{n}/{banded}"] = (hist, logs, np.asarray(pool.alive))
    return out


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("data", [None, 1, 2, 3])
def test_mesh_shape_matches_jax(n, data):
    try:
        want = tuple(jax_mesh_mod.make_mesh(n, data=data).shape.values())
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh_shape(n, data)
        return
    assert mesh_shape(n, data) == want


def test_make_mesh_on_the_ranks(runs):
    port, _, _, _ = runs
    for world in (2, 4):
        m = {k[5:]: str(v) for k, v in port[world].items() if k.startswith("mesh/")}
        for data in (None, 1, world):
            want = tuple(jax_mesh_mod.make_mesh(world, data=data).shape.values())
            assert m[f"make_mesh/{data}"] == str(want), (world, data)
        assert "needs" in m[f"error/{dict(n_devices=world * 2)}"]
        assert "does not divide" in m[f"error/{dict(data=3)}"]
        # one host: data defaults to 1 host; a host a rank: data = world
        assert m["multihost/one host"] == str((1, world))
        assert m["multihost/host a rank"] == str(((world, 1), world))
        assert "multiple of" in m["multihost/error"] or "does not divide" in m["multihost/error"]
    assert make_mesh().shape == {"data": 1, "gs": 1}  # no process group: one rank


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4)])
def test_process_batch_rows_match_jax(shape):
    data, gs = shape
    jmesh = jax_mesh_mod.make_mesh(data * gs, data=data)
    for batch in (data, 2 * data):
        rows = []
        for d in range(data):  # every data row's ranks, in rank order
            mine = [process_batch_rows(Mesh(data, gs, d * gs + g, {}), batch) for g in range(gs)]
            assert all(r == mine[0] for r in mine)
            rows += mine[0]
        assert rows == jax_batch_rows(jmesh, batch)
    if data > 1:
        with pytest.raises(ValueError, match="not divisible"):
            process_batch_rows(Mesh(data, gs, 0, {}), data + 1)


def _assert_step_close(got, want, lrs, what):
    """test_torch_train.py's step tolerances: each parameter within 1e-3 of
    its group's learning rate, cunt equal, grad_accum within 5e-4 x max."""
    for k in GROUPS:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3 * lrs[k], rtol=0,
                                   err_msg=f"{what} {k}")
    np.testing.assert_array_equal(got["cunt"], want["cunt"], err_msg=what)
    np.testing.assert_allclose(got["grad_accum"], want["grad_accum"],
                               atol=5e-4 * max(1.0, float(np.abs(want["grad_accum"]).max())),
                               err_msg=what)


def _jax_state_dict(p, st):
    return {**_leaves(p, POOL_FIELDS), **_leaves(st, ("grad_accum", "cunt"))}


def _port_state(res, prefix):
    return {k: res[f"{prefix}/{k}"] for k in POOL_FIELDS + ("grad_accum", "cunt")}


def _one_rank_step(jx, inp, prefix, batch):
    """The port's own step on one rank (no process group) from the same
    start state: the batched step at ``batch`` cameras, or
    make_train_step on one camera."""
    s, gts = jx[prefix][:2]
    pool, adam, stats = _state(inp, prefix)
    cams = [camera_from_numpy(c) for c in s["cameras"][:batch]]
    if prefix == "step":
        step = make_sharded_train_step(make_mesh(), _cfg(), s["scene_size"], MAX_STEPS)
        loss, _ = step(pool, adam, stats, cams, torch.from_numpy(gts[:batch]))
    else:
        step = make_train_step(_cfg(TALL_MAX_PATCHES), s["scene_size"], MAX_STEPS, device="cpu")
        loss, _ = step(pool, adam, stats, cams[0], torch.from_numpy(gts[0]))
    res = {}
    _put_state(res, "one", pool, stats)
    return float(loss), _port_state(res, "one")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_sharded_step_matches_jax_and_one_rank(runs, shape):
    port, jres, jx, inp = runs
    res = port[shape[0] * shape[1]]
    jloss, jp, ja, jst = jres[f"sharded{shape}"]
    s = jx["step"][0]
    lrs = {k: f(1) for k, f in make_lr_fns(_cfg(), s["scene_size"], MAX_STEPS).items()}
    got = _port_state(res, f"sharded{shape}")
    np.testing.assert_allclose(res[f"sharded{shape}/loss"], jloss, rtol=1e-5)
    assert int(res[f"sharded{shape}/dropped"]) == 0
    _assert_step_close(got, _jax_state_dict(jp, jst), lrs, "vs JAX")
    loss1, one = _one_rank_step(jx, inp, "step", 2)
    np.testing.assert_allclose(res[f"sharded{shape}/loss"], loss1, rtol=0, atol=2e-5)
    for k in GROUPS:
        np.testing.assert_allclose(got[k], one[k], atol=3e-5, err_msg=k)
    np.testing.assert_array_equal(got["cunt"], one["cunt"])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_sharded_step_collective_bytes(runs, shape):
    """Per step: the table all-gather over gs moves cap x 12 float32 a
    camera (JAX's compiled gather moves cap x (12 x 4 + 1) B of its
    attribute arrays, test_parallel.py), the alive mask cap bytes; the
    all-reduce over data moves this rank's rows of the parameter and
    screen gradients, with the loss, the drops and the visibility."""
    port, _, _, _ = runs
    data, gs = shape
    res = port[data * gs]
    b = {k.split("/bytes/")[1]: int(v) for k, v in res.items()
         if k.startswith(f"sharded{shape}/bytes/")}
    cams = 2 // data
    rows = STEP_CAP // gs
    assert b.pop("all_gather/gs/table") == cams * STEP_CAP * TABLE_COLS * 4
    assert b.pop("all_gather/gs/alive") == STEP_CAP
    assert b.pop("all_reduce/data/grads") == rows * (59 + 2) * 4
    assert b.pop("all_reduce/data/visible") == rows
    assert b.pop("all_reduce/data/loss") == 4
    assert b.pop("all_reduce/data/dropped") == 4
    assert not b, b  # nothing else, and nothing over "all"


@pytest.mark.parametrize("n", [2, 4])
def test_banded_step_matches_jax_and_single(runs, n):
    port, jres, jx, inp = runs
    res = port[n]
    jloss, jp, ja, jst = jres[f"banded{n}"]
    got = _port_state(res, f"banded{n}")
    np.testing.assert_allclose(res[f"banded{n}/loss"], jloss, rtol=0, atol=2e-5)
    assert int(res[f"banded{n}/dropped"]) == 0
    want = _jax_state_dict(jp, jst)
    for k in GROUPS:
        np.testing.assert_allclose(got[k], want[k], atol=5e-5, err_msg=k)
    np.testing.assert_array_equal(got["cunt"], want["cunt"])
    loss1, one = _one_rank_step(jx, inp, "band", 1)
    np.testing.assert_allclose(res[f"banded{n}/loss"], loss1, rtol=0, atol=2e-5)
    for k in GROUPS:
        np.testing.assert_allclose(got[k], one[k], atol=5e-5, err_msg=k)
    np.testing.assert_allclose(got["grad_accum"], one["grad_accum"], atol=1e-5)
    np.testing.assert_array_equal(got["cunt"], one["cunt"])
    b = {k.split("/bytes/")[1]: int(v) for k, v in res.items()
         if k.startswith(f"banded{n}/bytes/")}
    assert b["all_gather/gs/table"] == 192 * TABLE_COLS * 4
    assert b["all_reduce/all/table_grad"] == 192 * TABLE_COLS * 4


@pytest.mark.parametrize("name", ["render", "tall"])
@pytest.mark.parametrize("n", [2, 4])
def test_banded_render_matches_jax(runs, name, n):
    port, jres, _, _ = runs
    res = port[n]
    want, want_drop = jres[f"{name}{n}"]
    assert want_drop == 0
    for banded in (True, False):
        img = res[f"{name}{n}/{banded}/image"]
        assert img.shape == want.shape
        np.testing.assert_allclose(img, want, atol=2e-6, err_msg=str(banded))
        assert int(res[f"{name}{n}/{banded}/n_dropped"]) == want_drop


def _without_numbers(lines):
    return [re.sub(r"(loss|psnr)=[-0-9.]+|\([0-9.]+s\)", r"\1=", ln) for ln in lines]


@pytest.mark.parametrize("n,banded", [(2, True), (4, False)])
def test_train_sharded_matches_jax(runs, n, banded):
    port, jres, _, _ = runs
    res = port[n]
    jhist, jlogs, jalive = jres[f"loop{n}/{banded}"]
    hist = json.loads(str(res[f"loop{n}/{banded}/history"]))
    logs = json.loads(str(res[f"loop{n}/{banded}/logs"]))
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    assert hist["n_alive"] == jhist["n_alive"]
    assert [e for e, _ in hist["psnr"]] == [e for e, _ in jhist["psnr"]]
    np.testing.assert_allclose([p for _, p in hist["psnr"]], [p for _, p in jhist["psnr"]],
                               rtol=1e-4)
    assert hist["overflow_steps"] == [0] * len(hist["loss"])
    assert _without_numbers(logs) == _without_numbers(jlogs)
    assert any("densify" in ln for ln in logs)
    np.testing.assert_array_equal(res[f"loop{n}/{banded}/alive"], jalive)


def test_banded_overflow_is_reported(runs):
    """A band budget of 64 patches: the banded step reports its drops (JAX's
    reports none), and train_sharded counts the overflowing steps and logs
    the single-device loop's warning once."""
    port, _, _, _ = runs
    res = port[2]
    assert int(res["overflow2/dropped"]) > 0
    assert np.isfinite(res["overflow2/loss"])
    hist = json.loads(str(res["loop2/overflow/history"]))
    logs = json.loads(str(res["loop2/overflow/logs"]))
    assert hist["overflow_steps"][0] > 0 and sum(hist["overflow_steps"]) >= hist["overflow_steps"][0]
    warnings = [ln for ln in logs if "WARNING: patch budget overflow" in ln]
    assert len(warnings) == 1 and warnings[0].startswith("[epoch 1]"), logs
