"""Standing large-scale training benchmark: time to PSNR 25.

Port of the repository's ``scripts/bench_scene.py`` (its ``main``,
``:36-306``), with its frozen scene and its JSON lines: a deterministic
synthetic scene at the scale of the Tanks and Temples *truck* scene, which
cannot be downloaded here --

  * 100,000 ground-truth gaussians (``make_synthetic_scene`` seed 42,
    ``log_scale_mean`` -3.4),
  * 100 cameras at 979x546,
  * an SfM-like initialisation: a jittered 60% subsample of the ground-truth
    positions with colours quantised to uint8, through the reference's init
    recipe (``points_to_gaussians``), in a pool of 2.5x that capacity,

trained with the reference recipe until the mean eval PSNR over 4 views
reaches ``--target-psnr`` (or ``--epochs``). ``--smoke`` is 2,000
gaussians, 8 cameras at 160x112 and 2^15 patches. ``--realism`` adds a
textured background shell, per-image exposure jitter and noise, and a
decimated (25%), strongly jittered init in a pool of 5x; ``--oracle-gt``
evaluates the ground-truth scene itself instead of training; ``--full``
runs the whole densify window with the adaptive budget and prints the
per-epoch curve.

On the card every step runs the CUDA kernels (backend ``cuda``); under
``--device cpu`` the plain path (``tiled``). The kernels are built before
the clock starts and the build's seconds are printed on their own line, so
the timed window holds no ``nvcc`` run. The attribution totals drop epoch 1,
as the JAX script does: there it holds the compile, here the first launches
(the caching allocator's growth, cuBLAS's set-up).

The realism noise is drawn by numpy, not ``jax.random.normal``: each image's
gain and noise seed come from ``np.random.default_rng(99)`` in the JAX
script's call order (so the gains are JAX's), and its noise is
``default_rng(seed).standard_normal(shape, float32) * 0.015``, the same on
the CPU and the card.

    python -m easygaussiansplatting_tpu_torch.bench_scene            # full run, one card
    python -m easygaussiansplatting_tpu_torch.bench_scene --smoke
    python -m easygaussiansplatting_tpu_torch.bench_scene --smoke --epochs 1 --device cpu
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.dataset import points_to_gaussians
from easygaussiansplatting_tpu_torch.data.gau_io import SH_C0, recarray_to_arrays
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene, render_gt_images
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.loop import render_pool_image, train
from easygaussiansplatting_tpu_torch.utils.device import resolve_device, synchronize
from easygaussiansplatting_tpu_torch.utils.image import psnr

# (ground-truth gaussians, cameras, width, height, max_patches): the frozen
# benchmark's shape constants; do not change them without a new baseline
FULL = (100_000, 100, 979, 546, 2**20)
SMOKE = (2000, 8, 160, 112, 2**15)


@dataclasses.dataclass
class Bench:
    """What :func:`build_bench` sets up: the scene (numpy arrays, cameras,
    scene_size), the ground-truth images [3,H,W] on the device, the realism
    gains (empty without --realism), the initial pool (None under
    --oracle-gt), its size and capacity, the eval camera ids, the config and
    the seconds the ground truth took."""

    scene: dict
    gt_images: list
    gains: list
    pool: object
    n_init: int
    capacity: int
    eval_ids: list
    config: TrainConfig
    gt_seconds: float


def realism_shell(scene, n_gt):
    """The scene with a textured background shell appended: gaussians on a
    sphere of 2.2 scene sizes around the camera ring, so that every view has
    background to model (``scripts/bench_scene.py:98-118``)."""
    brng = np.random.default_rng(1234)
    n_bg = max(64, n_gt // 8)
    dirs = brng.normal(size=(n_bg, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    shell_r = 2.2 * scene["scene_size"]
    bg_rots = brng.normal(size=(n_bg, 4))
    bg_rots /= np.linalg.norm(bg_rots, axis=1, keepdims=True)
    scene = {**scene}
    scene["pws"] = np.concatenate([scene["pws"], dirs * shell_r])
    scene["rots"] = np.concatenate([scene["rots"], bg_rots])
    scene["scales"] = np.concatenate([scene["scales"],
                                      np.exp(brng.normal(size=(n_bg, 3)) * 0.3 - 1.0)])
    scene["alphas"] = np.concatenate([scene["alphas"], 0.4 + 0.5 * brng.random(n_bg)])
    scene["shs"] = np.concatenate([scene["shs"], brng.normal(size=(n_bg, 3)) * 0.6])
    return scene


def photometric_noise(images):
    """Per-image exposure jitter and sensor noise, unmodellable by the scene
    (``scripts/bench_scene.py:133-144``): clip(image * gain + 0.015 * N(0, 1),
    0, 1). Returns (noisy images, gains)."""
    nrng = np.random.default_rng(99)
    noisy, gains = [], []
    for im in images:
        gain = 1.0 + nrng.normal() * 0.03
        seed = int(nrng.integers(2**31))
        noise = np.random.default_rng(seed).standard_normal(tuple(im.shape), dtype=np.float32)
        noise = torch.from_numpy(noise).to(im.device)
        noisy.append(torch.clamp(im * gain + 0.015 * noise, 0.0, 1.0))
        gains.append(gain)
    return noisy, gains


def sfm_init(scene, n_gt, realism, rng_seed=7):
    """SfM-like init from the ground truth (``scripts/bench_scene.py:181-197``):
    a subsample (60%, or 25% under realism) of the scene's positions
    jittered by N(0, 0.01) (0.03), colours quantised to uint8 as a real
    points3D.bin holds them, through ``points_to_gaussians``. Returns the
    gaussians' arrays and the number kept."""
    rng = np.random.default_rng(rng_seed)
    n_total = len(scene["pws"])
    frac, jit = (0.25, 0.03) if realism else (0.6, 0.01)
    keep = rng.permutation(n_total)[: int(frac * n_gt)]
    xyz = scene["pws"][keep] + rng.normal(scale=jit, size=(len(keep), 3))
    rgb = np.clip((scene["shs"][keep] * SH_C0 + 0.5) * 255, 0, 255).astype(np.uint8)
    return recarray_to_arrays(points_to_gaussians(xyz, rgb)), len(keep)


def build_bench(smoke=False, realism=False, device="cuda", cap_factor=None, epochs=60,
                full=False, oracle_gt=False):
    """The benchmark's set-up: the frozen scene, its ground truth rendered on
    ``device`` (kept there), the realism shell and noise, the SfM-like init
    in its pool (skipped under ``oracle_gt``), the eval ids and the config
    (backend ``cuda`` on a CUDA device, ``tiled`` on the CPU; the adaptive
    budget only under ``full``)."""
    dev = resolve_device(device)
    n_gt, n_cams, width, height, max_patches = SMOKE if smoke else FULL
    scene = make_synthetic_scene(seed=42, n_gaussians=n_gt, n_cams=n_cams, width=width,
                                 height=height, log_scale_mean=-3.4)
    if realism:
        scene = realism_shell(scene, n_gt)
    config = TrainConfig(epochs=epochs, backend="cuda" if dev.type == "cuda" else "tiled",
                         max_patches=max_patches, adaptive_budget=full)
    t_gt = time.perf_counter()
    gt_images = render_gt_images(scene, config, device=dev)
    gains = []
    if realism:
        gt_images, gains = photometric_noise(gt_images)
    synchronize(dev)
    gt_seconds = time.perf_counter() - t_gt
    pool, n_init, capacity = None, 0, 0
    if not oracle_gt:
        gs, n_init = sfm_init(scene, n_gt, realism)
        factor = cap_factor or (5.0 if realism else 2.5)  # densify has to grow more
        capacity = ((int(factor * n_init) + 255) // 256) * 256
        pool = pool_from_arrays(gs["pws"], gs["rots"], gs["scales"], gs["alphas"], gs["shs"],
                                capacity=capacity, device=dev)
    eval_ids = list(range(0, n_cams, max(1, n_cams // 4)))[:4]
    return Bench(scene=scene, gt_images=gt_images, gains=gains, pool=pool, n_init=n_init,
                 capacity=capacity, eval_ids=eval_ids, config=config, gt_seconds=gt_seconds)


def eval_psnr(pool, bench):
    """Mean PSNR of the pool's renders of the eval views against their
    ground truth, both clipped to [0, 1]."""
    vals = []
    for i in bench.eval_ids:
        img, _ = render_pool_image(pool, bench.scene["cameras"][i], bench.config,
                                   need_grads=False)
        vals.append(float(psnr(torch.clamp(img, 0, 1), torch.clamp(bench.gt_images[i], 0, 1))))
    return float(np.mean(vals))


def oracle_psnr(bench, realism):
    """The reconstruction upper bound: the ground-truth scene itself as the
    pool, evaluated on the eval views. Returns the JSON row."""
    s = bench.scene
    n_total = len(s["pws"])
    cap = ((n_total + 255) // 256) * 256
    pool = pool_from_arrays(s["pws"], s["rots"], s["scales"], s["alphas"], s["shs"],
                            capacity=cap, device=bench.gt_images[0].device)
    vals, drops = [], 0
    for i in bench.eval_ids:
        img, aux = render_pool_image(pool, s["cameras"][i], bench.config, need_grads=False)
        drops += int(aux["binning"]["n_dropped"]) + int(aux["binning"]["rows_dropped"])
        vals.append(float(psnr(torch.clamp(img, 0, 1), torch.clamp(bench.gt_images[i], 0, 1))))
    if drops:
        print(f"WARNING: oracle renders dropped {drops} patches/rows — PSNR is an "
              f"underestimate; raise max_patches", flush=True)
    return {
        "metric": "oracle_gt_psnr" + ("_realism" if realism else ""),
        "value": round(float(np.mean(vals)), 3),
        "unit": f"mean eval PSNR of the ground-truth pool ({n_total} gaussians) vs the "
                f"{'noisy ' if realism else ''}eval views; per-view {[round(v, 2) for v in vals]}",
        "vs_baseline": 0.0,
    }


def run(bench, target_psnr=25.0, full=False, log_fn=print):
    """Train ``bench.pool`` until the eval PSNR reaches ``target_psnr`` (or
    through every epoch under ``full``), evaluating after each epoch.
    Returns the state: "curve" (a row per epoch), "psnr", "epoch_hit",
    "wall" (seconds to the target, or to the end), "t_start", "history" (the
    training loop's, as of the last epoch)."""
    n_cams = len(bench.scene["cameras"])
    state = {"t0": None, "t_hit": None, "psnr": 0.0, "epoch_hit": None, "curve": [],
             "history": None}
    t_start = time.time()

    def cb(epoch, pool, adam_state=None, stats=None, key=None, history=None):
        state["history"] = history
        if state["t0"] is None:
            state["t0"] = time.time()  # first epoch done: its launches excluded below
        if state["t_hit"] is not None and not full:
            return
        t_ev = time.time()
        p = eval_psnr(pool, bench)
        t_ev = time.time() - t_ev
        state["psnr"] = p
        # host-vs-device attribution: the loop records one synced step (device
        # time) and the whole steps phase per epoch; the difference is what
        # the host adds (dispatch, argument handling, sync reads)
        tdev = history["t_step_device"][-1] if history else None
        twall = history["t_steps_wall"][-1] if history else None
        tdfy = history["t_densify"][-1] if history else None
        row = {
            "epoch": epoch,
            "wall_s": round(time.time() - t_start, 1),
            "psnr": round(p, 3),
            "alive": int(pool.n_alive()),
            "budget": history["budget"][-1] if history else None,
            "overflow_steps": history["overflow_steps"][-1] if history else None,
            "t_steps_wall": round(twall, 2) if twall is not None else None,
            "t_device_est": round(tdev * n_cams, 2) if tdev is not None else None,
            "t_densify": round(tdfy, 2) if tdfy is not None else None,
            "t_eval": round(t_ev, 2),
        }
        state["curve"].append(row)
        log_fn(f"  [epoch {epoch}] eval psnr {p:.2f} alive {row['alive']} budget "
               f"{row['budget']} steps {row['t_steps_wall']}s (dev~{row['t_device_est']}s) "
               f"densify {row['t_densify']}s eval {row['t_eval']}s")
        if p >= target_psnr and state["t_hit"] is None:
            state["t_hit"] = time.time()
            state["epoch_hit"] = epoch
            if not full:
                raise StopIteration  # caught below: target reached

    try:
        train(bench.pool, bench.scene["cameras"], bench.gt_images, bench.config,
              bench.scene["scene_size"], seed=0, log_fn=log_fn, eval_every=10**9, epoch_cb=cb)
    except StopIteration:
        pass
    state["t_start"] = t_start
    state["wall"] = (state["t_hit"] or time.time()) - t_start
    return state


def result_lines(state, target_psnr, realism, full):
    """The JSON objects the JAX script prints after training, with its keys
    and metric names."""
    suffix = "_realism" if realism else ""
    curve = state["curve"]
    if full:
        return [{"curve" + suffix: curve}, {
            "metric": "truck_full_regime" + suffix,
            "value": round(state["psnr"], 2),
            "unit": (f"final psnr @ epoch {len(curve)}, "
                     f"{round(time.time() - state['t_start'], 1)}s wall; "
                     + (f"psnr>={target_psnr} at epoch {state['epoch_hit']} "
                        f"({round(state['wall'], 1)}s); " if state["epoch_hit"] is not None
                        else f"psnr>={target_psnr} not reached; ")
                     + f"alive {curve[-1]['alive'] if curve else 0}"),
            "vs_baseline": 0.0,
        }]
    # attribution totals over the recorded epochs: how much of the wall was
    # device step time against host-added overhead; epoch 1 is dropped (its
    # synced step holds the first launches)
    rows = [r for r in curve if r.get("t_steps_wall")]
    rows = rows[1:] if len(rows) > 1 else rows
    att = {}
    if rows:
        att = {
            "steps_wall_s": round(sum(r["t_steps_wall"] for r in rows), 1),
            "device_est_s": round(sum(r["t_device_est"] or 0 for r in rows), 1),
            "densify_s": round(sum(r["t_densify"] or 0 for r in rows), 1),
            "eval_s": round(sum(r["t_eval"] for r in rows), 1),
        }
        att["host_overhead_s"] = round(att["steps_wall_s"] - att["device_est_s"], 1)
    return [{"attribution" + suffix: att, "curve" + suffix: curve}, {
        "metric": "time_to_psnr25" + suffix,
        "value": round(state["wall"], 1),
        "unit": f"s wall (first launches included, kernel build not) to psnr>={target_psnr}, "
                f"epoch {state['epoch_hit']}, final psnr {state['psnr']:.2f}",
        "vs_baseline": 0.0,
    }]


def main(argv=None):
    """Run the benchmark on ``argv``; returns what it printed as JSON (a
    list of objects) and the training state (None under --oracle-gt)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--target-psnr", type=float, default=25.0)
    ap.add_argument("--smoke", action="store_true", help="tiny CI-sized run")
    ap.add_argument("--batch", type=int, default=1,
                    help="accepted as the JAX script accepts it; it reads it nowhere")
    ap.add_argument("--realism", action="store_true",
                    help="harder preset: per-image photometric noise and exposure jitter, a "
                         "textured background shell, and a decimated (25%%), strongly "
                         "jittered SfM init")
    ap.add_argument("--oracle-gt", action="store_true",
                    help="no training: evaluate the ground-truth pool against the (noisy, "
                         "for --realism) eval views and print the PSNR, the reconstruction "
                         "upper bound")
    ap.add_argument("--cap-factor", type=float, default=None,
                    help="override the pool-capacity factor (default 2.5, realism 5.0)")
    ap.add_argument("--full", action="store_true",
                    help="do not stop at the target: run the whole densify window with the "
                         "adaptive budget and print the per-epoch curve")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if dev.type == "cuda":
        _, build_s, _ = _build.build()
        _build.library()
        print(f"kernel build: {build_s:.1f} s (before the clock starts)", flush=True)
    bench = build_bench(args.smoke, args.realism, dev, args.cap_factor, args.epochs, args.full,
                        args.oracle_gt)
    n_cams = len(bench.scene["cameras"])
    print(f"rendered {n_cams} GT views in {bench.gt_seconds:.1f}s (realism={args.realism})",
          flush=True)
    if args.oracle_gt:
        line = oracle_psnr(bench, args.realism)
        print(json.dumps(line))
        return [line], None

    cam = bench.scene["cameras"][0]
    print(f"init {bench.n_init} gaussians (capacity {bench.capacity}), {n_cams} cams "
          f"{cam.width}x{cam.height}, backend={bench.config.backend}", flush=True)
    state = run(bench, args.target_psnr, args.full,
                log_fn=lambda msg: print(msg, flush=True))
    lines = result_lines(state, args.target_psnr, args.realism, args.full)
    if dev.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev)} B "
              f"({torch.cuda.get_device_name(dev)})", flush=True)
    for line in lines:
        print(json.dumps(line))
    return lines, state


if __name__ == "__main__":
    main()
