"""Driver ``train``: the program's epoch driver (``train/loop.py::train``)
from a fresh SfM-like init for the whole window, evaluating after each epoch.

Set-up builds the kernels, makes the frozen ground-truth scene and its
cameras (``benchmark/scene.py``), renders the ground truth with the
program, makes the init from ``--seed`` and warms every shape of the cell
(steps, densify, alpha reset, eval renders) on a throwaway pool. The window
runs ``train`` on a fresh pool of the same init; each step goes through a
thin wrapper of the step the driver builds, which closes the window at
``--seconds`` (the queue is drained and counted) and keeps what the
comparison needs: the first three steps' losses and views, the Adam state
after the first, the parameters before the first and after the third, and
the pool evaluated where the eval PSNR first reached the target.

After the window the reference (``benchmark/reference``) re-derives the
ground truth of those views, runs the first three steps itself from the same
init, and renders the evaluated pool; ``correct`` holds the program to it.
With ``--trace 1`` one stretch of steps is profiled and the blend kernels'
inputs kept for the per-layer readers.
"""

import time

import numpy as np
import torch

from benchmark import blend
from benchmark import scene as bscene
from benchmark.reference import render as ref_render
from benchmark.reference import train as ref_train
from benchmark.trace import Keeper, Profile


class WindowClosed(Exception):
    """Raised by the step wrapper once the window's time is up."""


class _Program:
    """The parts of the program this driver drives, imported on use."""

    def __init__(self):
        from easygaussiansplatting_tpu_torch.models.camera import Camera
        from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
        from easygaussiansplatting_tpu_torch.ops import rasterize as ops_rasterize
        from easygaussiansplatting_tpu_torch.ops.kernels import _build, preprocess, rasterize, scan
        from easygaussiansplatting_tpu_torch.train import density, loop, optimizer
        from easygaussiansplatting_tpu_torch.train.config import TrainConfig

        self.Camera, self.pool_from_arrays, self.TrainConfig = Camera, pool_from_arrays, TrainConfig
        self.render = ops_rasterize.render
        self.build, self.preprocess, self.rasterize, self.scan = _build, preprocess, rasterize, scan
        self.loop, self.density, self.optimizer = loop, density, optimizer


def psnr(image, gt):
    mse = torch.mean((torch.clamp(image, 0, 1) - torch.clamp(gt, 0, 1)) ** 2)
    return float(10.0 * torch.log10(1.0 / mse))


def clone_params(pool):
    return {k: v.detach().clone() for k, v in pool.params().items()}


class Window:
    """The timed training: the step wrapper, the epoch callback and what they
    keep."""

    def __init__(self, run, prog, pool, cams, gt, config, eval_ids, target):
        self.run, self.p, self.pool, self.cams, self.gt = run, prog, pool, cams, gt
        self.config, self.eval_ids, self.target = config, eval_ids, target
        self.cam_index = {id(c): i for i, c in enumerate(cams)}
        self.losses, self.drops, self.views = [], [], []
        self.n = 0
        self.snap = {}
        self.evals = []
        self.history = None
        prof = run.workload.get("profile", {})
        self.profile_at = [prof["first_step"] + i * prof["every"] for i in range(prof["tries"])] \
            if run.trace and run.device == "cuda" and prof else []
        self.profile_steps = prof.get("steps", 0)
        self.profile = None

    def evaluate(self):
        with torch.no_grad():
            vals = [psnr(self.p.loop.render_pool_image(self.pool, self.cams[i], self.config,
                                                       need_grads=False)[0], self.gt[i])
                    for i in self.eval_ids]
        return float(np.mean(vals))

    def start(self, t0):
        self.t0 = t0
        self.deadline = t0 + self.run.seconds

    def factory(self, make_step):
        def make(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def timed_step(pool, adam_state, stats, cam, gt_image):
                if time.perf_counter() >= self.deadline:
                    raise WindowClosed
                i = self.n
                if i == 0:
                    self.snap["p0"] = clone_params(pool)
                if i in self.profile_at and self.profile is None:
                    self._profile_start()
                t = time.perf_counter()
                loss, binfo = step(pool, adam_state, stats, cam, gt_image)
                self.run.spans.add("train step", t, time.perf_counter())
                self.losses.append(loss)
                self.drops.append(binfo["dropped"])
                if i < 3:
                    self.views.append(self.cam_index[id(cam)])
                if i == 0:
                    self.snap["mu1"] = {k: v.clone() for k, v in adam_state.mu.items()}
                if i == 2:
                    self.snap["p3"] = clone_params(pool)
                self.n += 1
                if self.profile is not None and self.n == self.profile_first + self.profile_steps:
                    self._profile_stop()
                return loss, binfo

            return timed_step

        return make

    def densify(self, fn):
        def timed(*args, **kwargs):
            with self.run.spans.span("densify"):
                return fn(*args, **kwargs)

        return timed

    def epoch_cb(self, epoch, pool, adam_state=None, stats=None, generator=None, history=None):
        self.history = history
        with self.run.spans.span("eval"):
            value = self.evaluate()
        t = time.perf_counter() - self.t0
        self.evals.append((t, value))
        if "eval" not in self.snap or self.snap["eval"]["psnr"] < self.target:
            self.snap["eval"] = {"params": clone_params(pool), "alive": pool.alive.clone(),
                                 "psnr": value, "epoch": epoch}

    def _profile_start(self):
        p = self.p
        self.groups = {"K1": (("preprocess_fwd_kernel",), p.preprocess.preprocess_fwd, 1),
                       "K2": (("preprocess_bwd_kernel",), p.preprocess.preprocess_bwd, 1),
                       "K4": (("rasterize_fwd_kernel",), p.rasterize.rasterize_fwd, 1),
                       "K5": (("rasterize_bwd_kernel",), p.rasterize.rasterize_bwd, 1),
                       "K6": (("seg_scan_kernel",), p.scan.segmented_cumsum, 1)}
        self._originals = {k: getattr(p.rasterize, k) for k in ("rasterize_fwd", "rasterize_bwd")}
        self.kept = {k: Keeper(fn, blend.STRIDE) for k, fn in self._originals.items()}
        for k, keeper in self.kept.items():
            setattr(p.rasterize, k, keeper)
        self.profile_first = self.n
        self.n_alive = int(self.pool.n_alive())
        self.profile = Profile(self.groups, self.run.spans)
        self.profile.start()

    def _profile_stop(self):
        self.profile.stop()
        for k, fn in self._originals.items():
            setattr(self.p.rasterize, k, fn)
        result = self.profile.reduce()
        if result is None:
            self.run.profile_lost = self.profile.lost
            self.profile = None
            return
        self.run.profile = result
        self.run.data["profile"] = {"steps": self.profile_steps, "n_alive": self.n_alive,
                                    "capacity": self.pool.capacity, "kept": self.kept}
        self.profile_at = []


def warm_up(prog, pool, cams, gt, config, scene_size, steps, dev):
    """Every shape of the cell on a throwaway pool: steps, densify and alpha
    reset, steps again, the eval render."""
    step = prog.loop.make_train_step(config, scene_size, config.epochs * len(cams), device=dev)
    adam = prog.optimizer.adam_init(pool.params())
    stats = prog.density.density_stats_init(pool.capacity, dev)
    for i in range(steps):
        step(pool, adam, stats, cams[i % len(cams)], gt[i % len(cams)])
    noise = prog.density.split_noise(pool.capacity, torch.Generator().manual_seed(0), dev)
    prog.density.densify_and_prune(pool, adam, stats, noise, scene_size, config)
    prog.density.reset_alpha(pool, adam, config)
    for i in range(steps):
        step(pool, adam, stats, cams[i % len(cams)], gt[i % len(cams)])
    with torch.no_grad():
        psnr(prog.loop.render_pool_image(pool, cams[0], config, need_grads=False)[0], gt[0])
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(run):
    p = _Program()
    dev = torch.device(run.device)
    cfg, wl = run.config, run.workload
    cuda = dev.type == "cuda"
    if cuda:
        p.build.build()
        p.build.library()
        torch.cuda.reset_peak_memory_stats()
    sc = bscene.synthetic_scene(cfg["gt_seed"], cfg["gt_gaussians"], cfg["views"], cfg["width"],
                                cfg["height"], log_scale_mean=cfg["log_scale_mean"])
    cams = [p.Camera.from_dict(c) for c in sc["cameras"]]
    config = p.TrainConfig(epochs=cfg["epochs"], backend="cuda" if cuda else "tiled",
                           max_patches=cfg["max_patches"], adaptive_budget=False)
    gt_args = [torch.tensor(np.asarray(sc[k]), dtype=torch.float32, device=dev)
               for k in ("pws", "shs", "alphas", "scales", "rots")]
    with torch.no_grad():
        gt = [p.render(*gt_args, cam, backend=config.backend, max_patches=config.max_patches,
                       need_grads=False, device=dev)[0] for cam in cams]
    del gt_args
    init = bscene.sfm_init(sc, cfg["gt_gaussians"], run.seed, cfg["init_fraction"],
                           cfg["init_jitter"])

    def new_pool():
        return p.pool_from_arrays(init["pws"], init["rots"], init["scales"], init["alphas"],
                                  init["shs"], capacity=cfg["capacity"], device=dev)

    warm_up(p, new_pool(), cams, gt, config, sc["scene_size"], wl["warmup_steps"], dev)
    pool = new_pool()
    n = len(cams)
    eval_ids = list(range(0, n, max(1, n // cfg["eval_views"])))[:cfg["eval_views"]]
    win = Window(run, p, pool, cams, gt, config, eval_ids, wl["target_psnr"])
    win.evals.append((0.0, win.evaluate()))
    make_step, densify = p.loop.make_train_step, p.loop.densify_and_prune
    p.loop.make_train_step, p.loop.densify_and_prune = win.factory(make_step), win.densify(densify)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_proc
    win.start(t0)
    try:
        p.loop.train(pool, cams, gt, config, sc["scene_size"], seed=run.seed,
                     log_fn=lambda *a, **k: None, eval_every=10**9, epoch_cb=win.epoch_cb)
    except WindowClosed:
        pass
    finally:
        p.loop.make_train_step, p.loop.densify_and_prune = make_step, densify
    if cuda:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    run.attempted = win.n
    losses, drops = torch.stack(win.losses), torch.stack(win.drops)
    run.failed = int(((drops > 0) | ~torch.isfinite(losses)).sum())
    every, until = config.densify_every_epochs, config.densify_until_epoch
    run.data.update({"steps": win.n, "evals": win.evals, "target_psnr": wl["target_psnr"],
                     "history": win.history, "width": cfg["width"], "height": cfg["height"],
                     "densify_epochs": [e for e in range(2, config.epochs + 1)
                                        if e % every == 0 and e <= until]})
    if cuda:
        run.memory_peak = torch.cuda.max_memory_allocated()
    program = {"losses": [float(x) for x in win.losses[:3]], "views": win.views,
               "snap": win.snap}
    del pool, gt, win, losses, drops
    compare(run, program, sc, init, dev)


def compare(run, program, sc, init, dev):
    """Hold the window's first three steps and its evaluated pool to the
    reference; records each number beside its limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lim = run.workload["limits"]
    run.check("failed", run.failed, 0)
    nums = reference_numbers(program, sc, init, run.config, dev)
    for name in ("loss_gap", "grad1_gap", "change3_gap", "eval_psnr_gap_db"):
        if name in nums:
            run.check(name, nums[name], lim[name])
    run.data["compared"] = nums


def gt_tensors(sc, dev, dtype=torch.float32):
    return {k: torch.tensor(np.asarray(sc[k]), dtype=dtype, device=dev)
            for k in ("pws", "shs", "alphas", "scales", "rots")}


def reference_numbers(program, sc, init, cfg, dev, dtype=torch.float32):
    """The numbers compared: the first steps' worst relative loss gap, the
    worst leaf's norm gap of the first gradient (from Adam's first moment
    after one step) and of the parameters' change after the third step, and
    the gap in dB of the evaluated pool's mean PSNR."""
    out = {}
    gt_scene = gt_tensors(sc, dev, dtype)
    k = len(program["views"])
    if k:
        views = [(sc["cameras"][i], ref_render.render(gt_scene, sc["cameras"][i]))
                 for i in program["views"]]
        ref = ref_train.steps(init, views, sc["scene_size"], cfg["epochs"] * cfg["views"], dev,
                              dtype)
        out["loss_gap"] = max(abs(a - b) / abs(b)
                              for a, b in zip(program["losses"], ref["losses"]))
        out["ref_losses"] = ref["losses"]
        snap = program["snap"]
        grad1 = {g: v / (1.0 - ref_train.B1) for g, v in snap["mu1"].items()}
        out["grad1_gap"], out["grad1_leaves"] = ref_train.leaf_gaps(grad1, ref["grad1"])
        if k >= 3:
            change = {g: snap["p3"][g] - snap["p0"][g] for g in snap["p0"]}
            want = {g: ref["end"][g] - ref["start"][g] for g in ref["end"]}
            keep = ref_train.moving_leaves(ref["grad1"])
            out["change3_gap"], out["change3_leaves"] = ref_train.leaf_gaps(
                {g: change[g] for g in keep}, {g: want[g] for g in keep})
        del ref
    ev = program["snap"].get("eval")
    if ev is not None:
        params = ref_train.activated({g: v.to(dtype) for g, v in ev["params"].items()})
        ids = list(range(0, cfg["views"], max(1, cfg["views"] // cfg["eval_views"])))
        vals = [ref_train.psnr(ref_render.render(params, sc["cameras"][i], alive=ev["alive"]),
                               ref_render.render(gt_scene, sc["cameras"][i]))
                for i in ids[:cfg["eval_views"]]]
        out["eval_psnr_gap_db"] = abs(ev["psnr"] - float(np.mean(vals)))
        out["eval_psnr"] = ev["psnr"]
    return out
