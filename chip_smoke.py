"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from easygaussiansplatting_tpu_torch/csrc and
drives the port's two paths at the configuration bench.py times (65,536
gaussians, SH degree 3, 979x546, max_patches 557,056, max_rows 229,376):

* the render path: a few renders through the port's entry point, checked
  against the all-plain path, then K1, K3 and K4 each held against its plain
  PyTorch version on the render's inputs, and the render CLI once; K1 also
  prints its registers, shared memory, spills (none allowed at degree 3)
  and resident blocks an SM at every SH degree, and its time at the epoch
  driver's capacity; K3 its plan (egs_multi_cumsum_plan), whose kernel
  count each call's profile must match, two float32 calls bit-equal, beside
  torch.cumsum a second yardstick, a 1-D torch.cumsum a row, and its time
  on rows far longer than binning's (2^21 and 2^24 positions); K4 and
  K5 also print the work this data needs (pairs, warp-iterations, K5's
  shuffles), their compiled inner loops (cuobjdump) and their registers
  and resident blocks an SM;
* the training path: ground truth of 4 views rendered by the port, a pool
  started from the scene with perturbed opacities and colours, and 23 steps
  of ``make_train_step`` (3 warm, 20 timed) cycling the views; then one step
  held against the all-plain step, two kernel steps held bit-equal, and K2,
  K5 and K6 each held against its plain version on the step's inputs; K2
  also prints its registers, shared memory, spills (none allowed) and
  resident blocks an SM, and its time at the epoch driver's capacity; K6 its
  plan (egs_segmented_cumsum_plan), whose kernel count one call's profile
  must match, and two calls bit-equal on the step's rows and on rows with a
  segment over four tiles;
* the sort routes, from the trained state: one kernel step on view 0 under
  each of the JAX package's opt-in sort flags (K8 in binning and the
  reduce; K7 in the gsid_counts inversion and the reduce; K7 with the
  10-array payload; K7 on two key words at a 2^21 patch budget), held
  against the default route, then K7 and K8 held against their plain
  versions on the inputs their wrappers received there;
* the epoch driver: ``train`` for 4 epochs of the 4 views at capacity
  131,072 with densify at epochs 2 and 4 and the adaptive budget, a
  checkpoint at epoch 2, and the resume from it held bit-equal to the resume
  from the state kept in memory;
* the K9 probe (``probes.micro_bench.run``: the three grid-overhead kernels
  and binning's sub-steps at scripts/micro_bench.py's sizes) and the K10
  probe (``probes.exp_dma_stream.run``: 4,096 chunked row sums at runtime
  offsets), each kernel then held against its plain version with a planted
  fault refused, timed beside its bytes bound, which K9a, K9v and K10 may
  not beat; K9v and K10 print their registers, spills and waves and are one
  device kernel a call, and K10's compiled kernel must hold a TMA bulk copy
  (cuobjdump, read right after the build with K4's and K5's loops);
* the render, train and bench CLIs once each, the train CLI once more with
  --preview --profile --debug-nans, the eval CLI on the train CLI's
  final.npy, the eval's per-view function on the driver's final pool
  against the 4 views at full width, and the gradient gate
  (``verify_gradients``, 36 checks) in a subprocess;
* the COLMAP path: the bench scene written as a COLMAP scene under
  build/smoke_colmap/ (one PINHOLE camera, the 4 poses, each photo the
  port's render at 1958x1092 with 0 patches dropped, written as PNG, and
  the 65,536 positions jittered as SfM points), built host libraries
  (native/colmap_reader.cc with the PNG unfilter by g++, the nvJPEG
  decoder by nvcc), the scene loaded at 0.5 by the native and the Python
  readers (equal to each other, cameras within 1e-9 of the scene's,
  photos bit-equal to the CPU path's decode and resize and within
  PHOTO_PSNR_MIN of the direct 979x546 renders, decoded by the port's PNG
  decoder and not PIL); nvJPEG on every committed JPEG fixture within its
  limits of PIL's decode, with planted faults refused; the PNG fixtures
  and the CUDA resize bit-equal to PIL's; then the train CLI with --path
  (2 epochs, 8 steps, in this process so that K1-K6's launches are counted
  from 0), the eval CLI and the render CLI with --path;
* the time-to-PSNR benchmark (``bench_scene``, in this process): --smoke
  for 6 epochs, K1-K6 launched exactly as often as its steps and renders
  need; the full preset (100,000 ground-truth gaussians, 100 cameras at
  979x546, an SfM-like init of 60,000 in a pool of 150,016), which must
  reach PSNR 25 by epoch BENCH_EPOCH_CAP, with its curve, attribution,
  overflow steps and peak device memory; --oracle-gt of both presets;
  --realism for 2 epochs at full size;
* the viewer: ``SceneRenderer`` on viewer_fps's scene (65,536 gaussians,
  degree 3, 979x546, max_patches 573,440) with the bench views as dataset
  cameras and a point cloud, every render mode, overlay toggle and cloud
  mode, axes and grid and the drag preview, each frame within 1 level of
  the all-plain path's (at most 0.1% of its pixels a level off) and
  launching K1 once, K3's 3 calls and K4 once; the HTTP server on an
  ephemeral port (PNG bodies decoded bit-equal to render()'s frames, 400,
  404); viewer_fps; a 4-frame GIF turntable read back with struct; and the
  training monitor over 2 epochs of train;
* the multi-device path (parallel/) at bench.py's width: world size 1
  under NCCL in this process (the batched step at batch 1 bit-equal to
  make_train_step, at batch 4 against the mean of 4 single-camera steps,
  the replicated render against render, train_sharded for 2 epochs at
  batch 2, one rank's step times); two ranks on the one card joined by
  gloo (``chip_smoke.py --md-rank``, child processes under a time limit,
  started beside it): the banded step and render over 2 bands and the
  batched step on (2, 1) and (1, 2), each against the world-size-1 result
  with 0 drops; then the train CLI with --batch 2 --mesh-data 1, entry(),
  dryrun_multichip(1) and bench_scaling at world size 1. K1-K6's launches,
  in this process and in each rank, are held to the steps and renders.

Each path's (or route's, or probe's) kernel launch counts are set to 0 just
before it runs and read just after. The render's, the step's and the
driver's profiles must trace as many records of each port kernel as its
wrapper launched in the window, or their device time and idle share are
not taken. Any failed check exits non-zero.

Output: per-phase lines, then the card's name and power limit as nvidia-smi
gives them, then on its own line a JSON object {"kernels": [...]} (per
kernel: launches on its path, max abs error against the plain version,
kernel / plain / library times in ms, the data-sheet bound), and last
{"ok": true, "device": {...}}.

Needs torch with CUDA and nvcc (CUDA_HOME, /usr/local/cuda or PATH); exits
non-zero without a CUDA device. Imports nothing of JAX.
"""

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from easygaussiansplatting_tpu_torch import bench_scene, graft_entry, viewer_fps
from easygaussiansplatting_tpu_torch.data import colmap, image_io, native_loader
from easygaussiansplatting_tpu_torch.data.dataset import (
    load_colmap_dataset,
    load_image,
    points_to_gaussians,
)
from easygaussiansplatting_tpu_torch.data.fixtures import rotmat2qvec, write_colmap_scene
from easygaussiansplatting_tpu_torch.data.make_io_fixtures import (
    FIXTURES,
    JPEGS,
    PNGS,
    RATES,
    planted_faults,
)
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.eval import evaluate_views
from easygaussiansplatting_tpu_torch.models.camera import Camera
from easygaussiansplatting_tpu_torch.models.convert import gaussians_from_numpy
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS, GaussianPool, pool_from_arrays
from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.binning import TILE, bin_gaussians, num_tiles
from easygaussiansplatting_tpu_torch.ops.blend import ALPHA_CLAMP, ALPHA_SKIP, chunk_alpha
from easygaussiansplatting_tpu_torch.ops.kernels import (
    _build,
    preprocess,
    radix,
    rasterize,
    scan,
    sort,
)
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.ops.rasterize_tiled import K_CHUNK
from easygaussiansplatting_tpu_torch.parallel.distributed import (
    fetch_to_host,
    free_port,
    init_distributed,
    launch_ranks,
)
from easygaussiansplatting_tpu_torch.parallel.loop import train_sharded
from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
from easygaussiansplatting_tpu_torch.parallel.train import (
    banded_loss_and_grads,
    make_sharded_render,
    make_sharded_train_step,
    shard_batch,
    shard_pool,
    sharded_loss_and_grads,
    stack_cameras,
)
from easygaussiansplatting_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import density_stats_init
from easygaussiansplatting_tpu_torch.train.loop import (
    PatchBudget,
    loss_and_grads,
    make_train_step,
    render_pool_image,
    train,
)
from easygaussiansplatting_tpu_torch.probes import ab, exp_dma_stream, micro_bench
from easygaussiansplatting_tpu_torch.train.__main__ import main as train_main
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init
from easygaussiansplatting_tpu_torch.utils.image import psnr, to_uint8
from easygaussiansplatting_tpu_torch.viewer.headless import render_turntable, save_gif
from easygaussiansplatting_tpu_torch.viewer.monitor import TrainingMonitor
from easygaussiansplatting_tpu_torch.viewer.server import CLOUD_MODES, MODES, SceneRenderer, serve

ROOT = Path(__file__).resolve().parent

# The configuration bench.py times.
WIDTH, HEIGHT = 979, 546
N_GAUSSIANS = 65536
SH_COLS = 48  # degree 3
MAX_PATCHES = 557056
MAX_ROWS = 229376
N_VIEWS = 4
SEED = 0
TRAIN_WARM, TRAIN_STEPS = 3, 20
# the two-word (tile, slot) route: mp_bits 21, so (2,170 + 1) << 21 > 2^32
LEX_MAX_PATCHES = 2_097_152
# K3 also on rows far longer than binning's: [rows, m]
LONG_SCANS = ((2, 2**21), (1, 2**24))
DRIVER_EPOCHS, DRIVER_CAPACITY = 4, 131072
# The COLMAP phase: the bench scene written as a COLMAP scene whose photos
# are the port's renders at twice the size (1958x1092), loaded at rate 0.5
# back to 979x546. A 2x render bins about 4x view 0's 512,134 patches.
COLMAP_DIR = ROOT / "build" / "smoke_colmap"
COLMAP_RATE = 0.5
PHOTO_MAX_PATCHES = 2**22
# SfM points as scripts/bench_scene.py jitters its init (seed 7, N(0, 0.01))
SFM_SEED, SFM_JITTER = 7, 0.01
# cameras read back from the scene against the scene's own, per field:
# |got - want| <= CAMERA_REL * max|want|
CAMERA_REL = 1e-9
# each photo, decoded and resized 0.5 on the card, against the direct
# 979x546 render of its view: a check that decode and resize are sound at
# full size (measured 47.98-48.14 dB on an NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md section 6)
PHOTO_PSNR_MIN = 45.0

# Published H100 SXM peaks (NVIDIA data sheet): device memory and FP32
# outside the tensor cores. INT32 adds are counted at half the FP32 rate
# (64 INT32 lanes per SM against 128 FP32); exp at 16 MUFU results per SM
# per clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = FP32_FLOP_PER_S / 2
MUFU_PER_SM_CLK = 16

# Tolerances, with their reasons:
# K1 runs the plain chain's expressions in the same order with multiply-add
# contraction off; what is left is the SH basis products and division
# rounding, far below 2e-5 (abs or rel).
K1_TOL = 2e-5
# the extents are ceil()s of a float; one ulp moves one only where the
# pre-ceil value sits on an integer
EXTENT_EDGE = 1e-4
# K3 int32 is exact; f32 sums in another order than torch.cumsum
K3_F32_RTOL = 1e-5
# K4 multiplies tau sequentially where the plain version takes chunked
# cumulative products; a threshold decision (alpha' >= 0.002, tau >= 1e-4)
# can flip on a pixel where a value sits on it
K4_TOL = 1e-4
K4_CONTRIB_MATCH = 0.9999
SLICE_TOL = 1e-4
SLICE_MAX_BAD_SHARE = 1e-3
# Gradient limits are relative to the values compared: the loss is a mean
# over 534,534 pixels, so every gradient is far below 1 and a limit relative
# to 1 could not fail. The kernel step against the all-plain step: the loss
# within rel 1e-5, each gradient group within STEP_REL * max|g| of its group.
# The two forwards differ (K4 multiplies tau sequentially, its plain version
# in chunked cumulative products) and each backward replays from its own
# tau, so the step reads up to 1.5e-3 * max|g| where every kernel is sound.
STEP_LOSS_RTOL = 1e-5
STEP_REL = 1e-2
# K2 and K5 against their plain versions on the same inputs: float32 sums in
# another order, each group (K2) or row (K5) within KERNEL_REL * max|want|.
KERNEL_REL = 1e-4
# a group whose values are all below this has nothing to compare
REL_FLOOR = 1e-12
# K6 against its float64 plain version: float32 running sums, within 1e-5
# of the segment's running sum of |x|
K6_RTOL = 1e-5
# A K7 route against the default route: the gradient sums within a gaussian
# may run in another order, each group within ROUTE_REL * max|g|. (K7 is a
# stable sort, so the sums run in the same order.)
ROUTE_REL = 1e-4
# K9b and K9v against their plain versions: float32 sums of each tile's
# chunks, within 1e-6 of the sum of |x| behind each value. K9b does the same
# adds in the same order (bit-equal). K9v sums a tile of n chunks in a fixed
# tree (csrc/micro_bench.cu) of rounding depth 3 + 3 + (ceil(n / 8) - 1) + 5:
# at most 12 at the script's <= 9 chunks a tile, so 12 * 2^-24 = 7.2e-7 of
# it in the worst case (15 and 8.9e-7 at 40 chunks). K10: float32 column sums
# of up to 128 rows in another order, within 1e-5 of the sum of |x| (depth
# 15 + 3 in the kernel: 1.1e-6; 128 * 2^-24 = 7.6e-6 for any order).
# Each limit must refuse a planted fault: one value moved by PLANTED of its
# sum of |x|.
K9_RTOL = 1e-6
K10_RTOL = 1e-5
PLANTED = 1e-3
GATE_CHECKS = 36
# K5's cross-pixel reduction (csrc/rasterize_bwd.cu): a 12-shuffle
# reduce-scatter of the nine terms per (entry, warp) with a live pair
K5_SHUFFLES = 12
# Hopper's SASS opcode of a bulk copy from global to shared memory
# (cp.async.bulk.shared::cluster.global, csrc/tma.cuh), which K9b's and K10's
# compiled kernels must hold
BULK_COPY_OPCODE = "UBLKCP"


# device kernel names of each port kernel (csrc/)
K1_NAMES = ("preprocess_fwd_kernel",)
K3_NAMES = ("multi_scan_kernel",)
K4_NAMES = ("rasterize_fwd_kernel",)
K2_NAMES = ("preprocess_bwd_kernel",)
K5_NAMES = ("rasterize_bwd_kernel",)
K6_NAMES = ("seg_scan_kernel",)
RENDER_GROUPS = (("K1", K1_NAMES), ("K3", K3_NAMES), ("K4", K4_NAMES))
STEP_GROUPS = RENDER_GROUPS + (("K2", K2_NAMES), ("K5", K5_NAMES), ("K6", K6_NAMES))
# each kernel's wrapper, whose launch count its path reads
WRAPPERS = {"K1 preprocess_fwd": preprocess.preprocess_fwd,
            "K2 preprocess_bwd": preprocess.preprocess_bwd,
            "K3 multi_cumsum": scan.multi_cumsum,
            "K4 rasterize_fwd": rasterize.rasterize_fwd,
            "K5 rasterize_bwd": rasterize.rasterize_bwd,
            "K6 segmented_cumsum": scan.segmented_cumsum,
            "K7 sort_pairs": sort.sort_pairs,
            "K8 counting_sort": radix.counting_sort,
            "K9a variant_a": micro_bench.variant_a,
            "K9b variant_b": micro_bench.variant_b,
            "K9v variant_vmem_resident": micro_bench.variant_vmem_resident,
            "K10 stream_sums": exp_dma_stream.stream_sums}
STEP_KERNELS = tuple(k for k in WRAPPERS if k.split()[0] in ("K1", "K2", "K3", "K4", "K5", "K6"))
ROUTE_KERNELS = ("K7 sort_pairs", "K8 counting_sort")
K9_KERNELS = ("K9a variant_a", "K9b variant_b", "K9v variant_vmem_resident")
# the sort routes: (label, flags, patch budget (None: the bench's), kernel)
ROUTES = (("K8 in binning and the reduce", {"EGS_RADIX_SORT": "1", "EGS_RADIX_REDUCE": "1"},
           None, "K8 counting_sort"),
          ("K7 in the gsid_counts inversion and the reduce", {"EGS_XLA_GRAD_SORT": "0"}, None,
           "K7 sort_pairs"),
          ("K7 with the 10-array payload", {"EGS_GRAD_PERM": "0"}, None, "K7 sort_pairs"),
          ("K7 on two key words", {"EGS_LEX_SORT": "1"}, LEX_MAX_PATCHES, "K7 sort_pairs"))
BIN_KEYS = ("patch_gsid", "patch_tile", "tile_start", "tile_cnt", "total", "n_dropped",
            "total_rows", "rows_dropped", "gsid_counts")


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def nvidia_smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


FLUSH_KERNEL = "bitwise_not"  # the L2 flush's kernel, left out of device times


def make_flush(device):
    buf = torch.zeros(96 * 2**20 // 4, dtype=torch.int32, device=device)  # > 50 MB L2
    return lambda: buf.bitwise_not_()


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and FLUSH_KERNEL not in e.name]


def short_name(name):
    """A device kernel's name without its return type, namespaces, template
    arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split(" ")[-1].split("::")[-1][-60:]


def event_ms(fn, clock_mhz, iters=20, warmup=3, flush=None):
    """Mean time per call of fn() between CUDA events recorded around it,
    with the L2 flushed (outside the events) before each call. A spin kernel
    first holds the device long enough for the host to queue every call, so
    the events time the device's work back to back, not the host's launch
    cost; a call that synchronises inside still pays its host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if flush is not None:
        flush()
    torch.cuda.synchronize()
    hold_s = min(2.0, 2.0 * iters * (time.perf_counter() - t0))
    torch.cuda._sleep(int(hold_s * clock_mhz * 1e6))
    marks = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def call_ms(fn, iters=20, warmup=3):
    """Mean time per call of fn() between CUDA events recorded around it,
    one call at a time: device time plus whatever host work (Python, the
    launch itself) the device waits on."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def timings(kern, plain, clock_mhz, flush, plain_iters=5, library=None):
    """event_ms of the kernel, of its plain version and (where one exists) of
    the library call, and the kernel's call_ms. The plain versions run few
    iterations: a hundred launches each would fill the device's queue of
    pending launches, and the host's pace would then enter the events."""
    return {"ms": event_ms(kern, clock_mhz, flush=flush),
            "plain_ms": event_ms(plain, clock_mhz, iters=plain_iters, warmup=1, flush=flush),
            "library_ms": None if library is None else event_ms(library, clock_mhz, flush=flush),
            "call_ms": call_ms(kern)}


def scene_params(device, sh_random):
    """The bench scene: 65,536 gaussians, 48 SH columns (DC from the scene;
    the rest zero as bench.py has it, or random with ``sh_random``)."""
    scene = make_synthetic_scene(seed=SEED, n_gaussians=N_GAUSSIANS, n_cams=N_VIEWS,
                                 width=WIDTH, height=HEIGHT, log_scale_mean=-3.6)
    shs = np.zeros((N_GAUSSIANS, SH_COLS), np.float32)
    shs[:, :3] = scene["shs"]
    if sh_random:
        shs[:, 3:] = np.random.default_rng(SEED + 1).normal(size=(N_GAUSSIANS, SH_COLS - 3)) * 0.3
    params = gaussians_from_numpy({**scene, "shs": shs}, device)
    return params, scene["cameras"]


def phase_k1(device, flush, clock_mhz, n_sm):
    params, cams = scene_params(device, sh_random=True)
    cam = cams[0]
    lines = []
    worst = 0.0
    timing = None
    for deg in (3, 0):
        p = dict(params)
        p["shs"] = params["shs"][:, :3 * (deg + 1) ** 2].contiguous()
        args = (p["pws"], p["shs"], p["alphas"], p["scales"], p["rots"], cam)
        got = preprocess.preprocess_fwd(*args, sh_degree=deg)
        want = preprocess.preprocess_plain(*args, sh_degree=deg)
        torch.cuda.synchronize()
        diff = (got[:, :10] - want[:, :10]).abs()
        bad = (diff > K1_TOL) & (diff > K1_TOL * want[:, :10].abs())
        cov2d = stages.preprocess(*args, sh_degree=deg)["cov2ds"]
        pre_ceil = 3.0 * torch.sqrt(torch.abs(cov2d[:, [0, 2]]))
        near_int = (pre_ceil - torch.round(pre_ceil)).abs() < EXTENT_EDGE
        ext_diff = got[:, 10:12] != want[:, 10:12]
        n_bad_ext = int((ext_diff & ~near_int).sum())
        err = float(diff.max())
        worst = max(worst, err)
        lines.append(f"K1 deg {deg}: max_abs_err {err:.3e}, float mismatches {int(bad.sum())}, "
                     f"extent mismatches {int(ext_diff.sum())} ({int(near_int.sum())} pre-ceil "
                     f"values within {EXTENT_EDGE} of an integer, {n_bad_ext} mismatches elsewhere)")
        require(int(bad.sum()) == 0, f"K1 deg {deg} float outputs differ beyond {K1_TOL}")
        require(n_bad_ext == 0, f"K1 deg {deg} extents differ away from integer edges")
        if deg == 3:
            timing = timings(lambda: preprocess.preprocess_fwd(*args, sh_degree=deg),
                             lambda: preprocess.preprocess_plain(*args, sh_degree=deg),
                             clock_mhz, flush)
            timing.update(k1_bound(p["pws"].shape[0], deg, clock_mhz, n_sm))
            # the epoch driver runs K1 over its whole capacity: the inputs
            # repeated up to DRIVER_CAPACITY gaussians
            reps = DRIVER_CAPACITY // N_GAUSSIANS
            big = [torch.cat([a] * reps) for a in args[:5]]
            ms_big = event_ms(lambda: preprocess.preprocess_fwd(*big, cam, sh_degree=deg),
                              clock_mhz, flush=flush)
            lines.append(f"K1 at the epoch driver's capacity, {DRIVER_CAPACITY} gaussians: "
                         f"{ms_big:.4f} ms by CUDA events, bound "
                         f"{k1_bound(DRIVER_CAPACITY, deg, clock_mhz, n_sm)['bound_ms']:.4f} ms "
                         f"by bytes")
    for deg in range(6):
        info = preprocess.kernel_info("fwd", deg)
        waves = [f"{-(-n // info['threads']) / (info['blocks_per_sm'] * n_sm):.2f}"
                 for n in (N_GAUSSIANS, DRIVER_CAPACITY)]
        lines.append(
            f"K1 as compiled (SH degree {deg}): {info['registers']} registers a thread, "
            f"{info['shared_bytes']} shared bytes a block of {info['threads']} threads, "
            f"{info['local_bytes']} local (spill) bytes a thread, {info['blocks_per_sm']} "
            f"resident blocks an SM; {waves[0]} waves at {N_GAUSSIANS} gaussians, {waves[1]} at "
            f"{DRIVER_CAPACITY}")
        if deg == 3:
            require(info["local_bytes"] == 0, f"K1 spills {info['local_bytes']} bytes a thread")
    return {"name": "K1 preprocess_fwd", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/preprocess.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/preprocess.py:170",
            "max_abs_err": worst, **timing}, lines


def k1_bound(n, deg, clock_mhz, n_sm):
    """K1's bound for n gaussians: the parameters read once, the table
    written once; stage math and the SH basis and sums counted."""
    nbytes = n * 4 * (3 + 3 * (deg + 1) ** 2 + 1 + 3 + 4) + n * 4 * preprocess.TABLE_COLS
    return bound(nbytes, n * (200 + 8 * (deg + 1) ** 2), 0, clock_mhz, n_sm)


def bound(nbytes, fp32_ops, exps, clock_mhz, n_sm, int_ops=0):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(fp32_ops / FP32_FLOP_PER_S, int_ops / INT32_OP_PER_S,
                exps / (MUFU_PER_SM_CLK * n_sm * clock_mhz * 1e6))
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_k3(device, flush, clock_mhz, n_sm):
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    # the three row sets one render scans at the bench budgets, sparse marks
    # like binning's; one row set a position longer, whose row 1 starts 4
    # bytes past a 16-byte boundary (the kernel's striped 4-byte path); and
    # one float32 set
    shapes = [(2, MAX_ROWS), (1, MAX_ROWS), (2, MAX_PATCHES), (2, MAX_ROWS + 1)]
    sets = []
    for r, m in shapes:
        x = torch.randint(-3, 4, (r, m), generator=gen, dtype=torch.int32)
        x = torch.where(torch.rand((r, m), generator=gen) < 0.3, x, 0)
        sets.append(x.to(device))
    xf = torch.rand((2, MAX_PATCHES), generator=gen).to(device)
    lines = []
    for x in sets + [xf]:
        r, m = x.shape
        plan = scan.multi_cumsum_plan(m, r)
        kernels = require_kernel_count(f"K3 on {tuple(x.shape)}", lambda x=x: scan.multi_cumsum(x),
                                       plan["launches"])
        lines.append(f"K3 plan (egs_multi_cumsum_plan) for {tuple(x.shape)}: tiles of "
                     f"{plan['tile']} positions, {r * -(-m // plan['tile'])} tiles, "
                     f"{plan['launches']} kernel launch and {plan['memsets']} memset a call, "
                     f"{plan['scratch']} scratch words; device kernels per call {kernels}")
    for x in sets:
        got = scan.multi_cumsum(x)
        want = scan.multi_cumsum_plain(x)
        n_bad = int((got != want).sum())
        lines.append(f"K3 int32 {tuple(x.shape)}: mismatches {n_bad}")
        require(n_bad == 0 and got.dtype == torch.int32, f"K3 int32 {tuple(x.shape)} differs")
    got = scan.multi_cumsum(xf)
    want = scan.multi_cumsum_plain(xf)
    ref = torch.cumsum(xf.double(), dim=1)
    cumabs = torch.cumsum(xf.double().abs(), dim=1)
    err = (got.double() - want.double()).abs()
    worst = float(err.max())
    n_bad = int((err > K3_F32_RTOL * cumabs).sum())
    equal = torch.equal(got, scan.multi_cumsum(xf))
    lines.append(f"K3 f32 {tuple(xf.shape)}: max_abs_err vs the plain version {worst:.3e}, "
                 f"beyond {K3_F32_RTOL}*cumsum|x|: {n_bad}; against float64 the kernel is off by "
                 f"{float((got.double() - ref).abs().max()):.3e}, torch.cumsum by "
                 f"{float((want.double() - ref).abs().max()):.3e}; two calls bit-equal: {equal}")
    require(n_bad == 0, "K3 f32 differs beyond tolerance")
    require(equal, "K3 f32: two calls differ")
    # one render's three calls: the times add up. The second yardstick:
    # torch.cumsum of each row as a 1-D tensor (CUB's device scan), R calls
    # a set; torch.cumsum(x, dim=1) hands a whole row to one block.
    timing, rows_ms = {}, 0.0
    for x in sets[:3]:
        t = timings(lambda x=x: scan.multi_cumsum(x), lambda x=x: scan.multi_cumsum_plain(x),
                    clock_mhz, flush, plain_iters=20,
                    library=lambda x=x: torch.cumsum(x, dim=1, dtype=torch.int32))
        timing = {k: timing.get(k, 0.0) + v for k, v in t.items()}
        rows = list(x)
        rows_ms += event_ms(lambda rows=rows: [torch.cumsum(v, 0, dtype=torch.int32) for v in rows],
                            clock_mhz, flush=flush)
    _, row_kernels = device_kernels(lambda: torch.cumsum(sets[2][0], 0, dtype=torch.int32))
    lines.append(f"K3 yardstick, torch.cumsum of each row as a 1-D tensor (5 calls a render): "
                 f"{rows_ms:.4f} ms a render by CUDA events; device kernels of one such call "
                 f"{row_kernels}")
    # rows far longer than binning's (512 and 4,096 tiles): the carry reads
    # every earlier tile's aggregate, tiles^2 / 2 words a row, beside the
    # bytes; its time is held beside CUB's
    for r, m in LONG_SCANS:
        x = torch.randint(-3, 4, (r, m), generator=gen, dtype=torch.int32).to(device)
        require(torch.equal(scan.multi_cumsum(x), scan.multi_cumsum_plain(x)),
                f"K3 int32 {(r, m)} differs")
        ms = event_ms(lambda x=x: scan.multi_cumsum(x), clock_mhz, flush=flush)
        cub = event_ms(lambda x=x: [torch.cumsum(v, 0, dtype=torch.int32) for v in x],
                       clock_mhz, flush=flush)
        lines.append(f"K3 int32 {(r, m)}: equal to the plain version; {ms:.4f} ms by CUDA "
                     f"events, a 1-D torch.cumsum a row {cub:.4f} ms, bound "
                     f"{bound(8 * r * m, 0, 0, clock_mhz, n_sm, int_ops=r * m)['bound_ms']:.4f} "
                     f"ms by bytes")
    elems = sum(x.numel() for x in sets[:3])
    return {"name": "K3 multi_cumsum", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/scan.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/scan.py:33",
            "max_abs_err": worst, **timing,
            **bound(elems * 8, 0, 0, clock_mhz, n_sm, int_ops=elems)}, lines


def k4_walk(tile_cnt, final_tau, contrib):
    """Each pixel's walk in K4 [H, W]: a pixel that saturated stops at its
    last contributor, any other one walks its whole tile list."""
    gx = -(-WIDTH // TILE)
    ty = torch.arange(HEIGHT, device=contrib.device)[:, None] // TILE
    tx = torch.arange(WIDTH, device=contrib.device)[None, :] // TILE
    return torch.where(final_tau < 1e-4, contrib.long(), tile_cnt.long()[ty * gx + tx])


@functools.cache
def sass_dump():
    """The built library's SASS (cuobjdump -sass, which must sit beside
    nvcc). main() reads it right after the build: a cuobjdump run after a
    torch.profiler window makes every later window lose its first device
    record (probes/profiler_records.py)."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    require(tool.exists(), f"{tool} is missing: the SASS checks need it")
    return subprocess.run([str(tool), "-sass", str(_build.BUILD_DIR / _build.LIB_NAME)],
                          capture_output=True, text=True, timeout=300, check=True).stdout


def sass_body(kernel):
    """[(address, instruction)] of the compiled device function whose name
    holds ``kernel``."""
    body = next(f for f in sass_dump().split("Function : ")[1:] if kernel in f.split("\n", 1)[0])
    return [(int(a, 16), i) for a, i in re.findall(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", body)]


def opcode(ins):
    """An instruction's opcode with its modifiers, past any predicate."""
    words = ins.split()
    return words[1] if words[0].startswith("@") else words[0]


def sass_loop(kernel):
    """The compiled inner loop of a blend kernel: (SASS instructions in the
    smallest loop that holds an ex2, its SHFL count). The loop is one
    warp-iteration of K4, one (entry, warp) step of K5."""
    ins = sass_body(kernel)
    at = {a: k for k, (a, _) in enumerate(ins)}
    loops = []
    for k, (a, i) in enumerate(ins):
        m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", i)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
            loop = [x for _, x in ins[at[int(m.group(1), 16)]:k + 1]]
            if any("MUFU.EX2" in x for x in loop):
                loops.append(loop)
    loop = min(loops, key=len)
    return len(loop), sum("SHFL" in x for x in loop)


def kernel_info_line(label, kernel):
    info = rasterize.kernel_info(kernel)
    return (f"{label} as compiled: {info['registers']} registers a thread, "
            f"{info['blocks_per_sm']} resident blocks an SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")


def phase_k4(device, flush, clock_mhz, n_sm):
    params, cams = scene_params(device, sh_random=False)
    cam = cams[0]
    pre = preprocess.fused_preprocess(params["pws"], params["shs"], params["alphas"],
                                      params["scales"], params["rots"], cam)
    b = bin_gaussians(pre["us"], pre["depths"], pre["areas"], pre["valid"], width=WIDTH,
                      height=HEIGHT, max_patches=MAX_PATCHES, max_rows=MAX_ROWS,
                      cinv2ds=pre["cinv2ds"], alphas=pre["alphas"])
    table = pre["table"]
    args = (table, b["patch_gsid"], b["tile_start"], b["tile_cnt"])
    img, tau, cont = rasterize.rasterize_fwd(*args, width=WIDTH, height=HEIGHT)
    img_p, tau_p, cont_p = rasterize.rasterize_plain(*args, width=WIDTH, height=HEIGHT)
    torch.cuda.synchronize()
    err_img = float((img - img_p).abs().max())
    err_tau = float((tau - tau_p).abs().max())
    n_cont_bad = int((cont != cont_p).sum())
    n_pix = WIDTH * HEIGHT
    lines = [f"K4 on view 0 ({int(b['total'])} patches): image max_abs_err {err_img:.3e}, "
             f"final_tau max_abs_err {err_tau:.3e}, contrib mismatches {n_cont_bad} of {n_pix}"]
    require(err_img <= K4_TOL and err_tau <= K4_TOL, "K4 image/tau differ beyond tolerance")
    require(n_cont_bad <= (1 - K4_CONTRIB_MATCH) * n_pix, "K4 contrib differs on too many pixels")
    timing = timings(lambda: rasterize.rasterize_fwd(*args, width=WIDTH, height=HEIGHT),
                     lambda: rasterize.rasterize_plain(*args, width=WIDTH, height=HEIGHT),
                     clock_mhz, flush, plain_iters=3)
    kept = int(b["tile_cnt"].sum())
    n_distinct = int(torch.unique(b["patch_gsid"][:kept]).numel()) if kept else 0
    n_tiles = b["tile_cnt"].numel()
    nbytes = kept * 4 + n_tiles * 8 + n_distinct * 9 * 4 + n_pix * 5 * 4
    work = blend_work(table, b["patch_gsid"], b["tile_start"], b["tile_cnt"],
                      k4_walk(b["tile_cnt"], tau, cont))
    lines.append(
        "K4 work this data needs: (entry, pixel) pairs evaluated {evaluated}, past the cutoff "
        "{passed}, live {live}; warp-iterations {warp_iters} (2 warps of 16x8 pixels a "
        "tile)".format(**work))
    lines.append(kernel_info_line("K4", "fwd"))
    loop = sass_loop("rasterize_fwd_kernel")
    lines.append(f"K4 compiled inner loop (cuobjdump -sass): {loop[0]} instructions a "
                 f"warp-iteration, {loop[0] / 4:.2f} per 32-pixel slot (4 pixels a lane); "
                 f"{loop[0] * work['warp_iters']} issued over this data's warp-iterations")
    return {"name": "K4 rasterize_fwd", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/rasterize_fwd.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/kernels.py:174",
            "max_abs_err": max(err_img, err_tau), **timing,
            **k4_bound(nbytes, work, clock_mhz, n_sm)}, lines


def phase_slice(device):
    """Serve N_VIEWS render requests through the port's entry point."""
    params, cams = scene_params(device, sh_random=False)
    args = [params[k] for k in ("pws", "shs", "alphas", "scales", "rots")]
    kw = dict(sh_degree=3, max_patches=MAX_PATCHES, max_rows=MAX_ROWS, need_grads=False,
              device=device)
    for w in WRAPPERS.values():
        w.launches = 0
    outs = [render(*args, cam, **kw) for cam in cams]
    torch.cuda.synchronize()
    launches = {"K1 preprocess_fwd": preprocess.preprocess_fwd.launches,
                "K3 multi_cumsum": scan.multi_cumsum.launches,
                "K4 rasterize_fwd": rasterize.rasterize_fwd.launches}
    lines = [f"render path launches over {len(cams)} views: {launches}"]
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    n_pix = WIDTH * HEIGHT
    for i, (cam, (img, aux)) in enumerate(zip(cams, outs)):
        bn = aux["binning"]
        dropped, rows_dropped = int(bn["n_dropped"]), int(bn["rows_dropped"])
        require(dropped == 0 and rows_dropped == 0,
                f"view {i} drops {dropped} patches / {rows_dropped} rows")
        require(img.shape == (3, HEIGHT, WIDTH) and bool(torch.isfinite(img).all()),
                f"view {i} image is not finite [3,H,W]")
        img_p, aux_p = render(*args, cam, backend="tiled", **kw)
        bad = int(((img - img_p).abs() > SLICE_TOL).any(dim=0).sum())
        same_bins = all(torch.equal(bn[k], aux_p["binning"][k])
                        for k in ("patch_gsid", "tile_start", "tile_cnt", "total"))
        lines.append(f"view {i}: {int(bn['total'])} patches, {int(bn['total_rows'])} rows, "
                     f"dropped 0/0, binning equal to the plain path: {same_bins}, pixels off "
                     f"the all-plain path by > {SLICE_TOL}: {bad} of {n_pix}, "
                     f"max_abs_err {float((img - img_p).abs().max()):.3e}, mean {float(img.mean()):.4f}")
        require(bad <= SLICE_MAX_BAD_SHARE * n_pix, f"view {i} differs from the plain path")

    aux = outs[0][1]
    aabb = bin_gaussians(aux["us"], aux["depths"], aux["areas"], aux["valid"], width=WIDTH,
                         height=HEIGHT, max_patches=MAX_PATCHES, max_rows=MAX_ROWS)
    lines.append(f"view 0 without ellipse row culling (3-sigma boxes only): "
                 f"{int(aabb['total'])} patches")

    def render_view0():
        return render(*args, cams[0], **kw)

    ms, line = render_wall(render_view0)
    lines.append(f"render (device-resident params, view 0): {line} -> "
                 f"{n_pix / (ms / 1e3) / 1e6:.3f} Mpix/s forward at the median")
    return launches, lines, (render_view0, ms)


def render_wall(render_once, samples=50, warmup=2):
    """Wall time of one render, from the host clock around work that ends in
    a synchronise: (median ms, a line with the median, the 80th percentile
    -- the highest with ten samples beyond it -- and the sample count)."""
    for _ in range(warmup):
        render_once()
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_once()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    med, p80 = np.percentile(times, [50, 80])
    return float(med), f"median {med:.3f} ms, p80 {p80:.3f} ms over {samples} renders"


PROFILE_TRIES = 3


def phase_profile(label, run_once, wall_ms, groups, reps=5, again=True):
    """Where the device time of one run goes (a profiled window of ``reps``
    runs), its idle share against the unprofiled median wall time, and, with
    ``again``, a second set of wall-time samples taken after the window.
    Each port kernel of ``groups`` launches one device kernel a call here
    (its plan), so its records in the window must number its wrapper's
    launches there. A window that lost a record is taken again, up to
    PROFILE_TRIES windows; where every one lost one, the line says so and
    gives no device time and no idle share. Returns (device ms per run or
    None, lines)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    wrappers = {k: next(w for n, w in WRAPPERS.items() if n.split()[0] == k) for k, _ in groups}
    lost = []
    for _ in range(PROFILE_TRIES):
        before = {k: w.launches for k, w in wrappers.items()}
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                run_once()
                torch.cuda.synchronize()
        events = _kernel_events(prof)
        if not events:  # a profiler that traces no device leaves the run unbroken-down
            return None, [f"{label} profile: torch.profiler recorded no device kernels"]
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        records = {k: sum(short_name(e.name) in names for e in events) for k, names in groups}
        if records == launched:
            break
        lost.append(", ".join(f"{k} {records[k]} of {launched[k]}" for k, _ in groups
                              if records[k] != launched[k]))
    else:
        return None, [f"{label} profile: every one of {PROFILE_TRIES} windows lost device "
                      f"records (port kernel records of launches: {'; '.join(lost)}); no device "
                      f"time or idle share taken"]
    by_name = {}
    for e in events:
        name = short_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    busy = sum(by_name.values())
    ours = {k: sum(v for n, v in by_name.items() if n in names) for k, names in groups}
    lines = [f"{label} device time {busy:.4f} ms per {label} ({len(by_name)} kernel names); "
             f"idle share of the {wall_ms:.3f} ms {label} {1 - busy / wall_ms:.3f}; port kernels "
             + ", ".join(f"{k} {v:.4f} ms" for k, v in ours.items())
             + f"; other kernels {busy - sum(ours.values()):.4f} ms; every port kernel's "
             f"records equal its launches ({reps} {label}s)"
             + (f", after {len(lost)} window(s) that lost some ({'; '.join(lost)})" if lost else "")]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    lines.append(f"{label} top device kernels: " + "; ".join(f"{n} {v:.4f} ms" for n, v in top))
    if again:
        lines.append(f"{label} wall time again: {render_wall(run_once)[1]}")
    return busy, lines


def train_setup(device, capacity=N_GAUSSIANS):
    """Ground truth of the N_VIEWS views rendered by the port, and a pool of
    ``capacity`` started from the scene with opacities and colours
    perturbed by a seeded generator (scales left alone, so the patch count
    stays inside the budget)."""
    scene = make_synthetic_scene(seed=SEED, n_gaussians=N_GAUSSIANS, n_cams=N_VIEWS,
                                 width=WIDTH, height=HEIGHT, log_scale_mean=-3.6)
    shs = np.zeros((N_GAUSSIANS, SH_COLS), np.float32)
    shs[:, :3] = scene["shs"]
    args = [scene["pws"], shs, scene["alphas"], scene["scales"], scene["rots"]]
    gts = [render(*args, cam, sh_degree=3, max_patches=MAX_PATCHES, max_rows=MAX_ROWS,
                  need_grads=False, device=device)[0] for cam in scene["cameras"]]
    gen = torch.Generator().manual_seed(SEED + 2)
    alphas = np.clip(scene["alphas"] + 0.1 * torch.randn(N_GAUSSIANS, generator=gen).numpy(),
                     0.05, 0.95)
    shs_p = shs.copy()
    shs_p[:, :3] += 0.2 * torch.randn((N_GAUSSIANS, 3), generator=gen).numpy()
    pool = pool_from_arrays(scene["pws"], scene["rots"], scene["scales"], alphas, shs_p,
                            capacity=capacity, device=device)
    cfg = TrainConfig(max_patches=MAX_PATCHES, max_rows=MAX_ROWS, sh_degree=3)
    return pool, scene["cameras"], gts, scene["scene_size"], cfg


def phase_train(device):
    """The training path: TRAIN_WARM + TRAIN_STEPS steps cycling the views,
    each timed on the host clock to a synchronise."""
    pool, cams, gts, scene_size, cfg = train_setup(device)
    n_steps = TRAIN_WARM + TRAIN_STEPS
    step = make_train_step(cfg, scene_size, n_steps, device=device)
    state = adam_init(pool.params())
    stats = density_stats_init(pool.capacity, device)
    for w in WRAPPERS.values():
        w.launches = 0
    losses, drops, times = [], [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, binfo = step(pool, state, stats, cams[i % N_VIEWS], gts[i % N_VIEWS])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        drops.append(binfo["dropped"])
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    losses = [float(v) for v in losses]
    drops = [int(v) for v in drops]
    per_step = {k: v / n_steps for k, v in launches.items()}
    lines = [f"training path launches over {n_steps} steps: {launches} ({per_step} per step)",
             f"training losses: " + " ".join(f"{v:.5f}" for v in losses)]
    require(all(launches[k] > 0 for k in STEP_KERNELS), f"a kernel was not launched: {launches}")
    require(all(launches[k] == 0 for k in ROUTE_KERNELS),
            f"a sort-route kernel ran on the default route: {launches}")
    require(all(d == 0 for d in drops), f"a step dropped patches or rows: {drops}")
    first, last = float(np.mean(losses[:N_VIEWS])), float(np.mean(losses[-N_VIEWS:]))
    require(last < first, f"the loss did not fall: first {first:.5f}, last {last:.5f}")
    med, p80 = np.percentile(times[TRAIN_WARM:], [50, 80])
    n_pix = WIDTH * HEIGHT
    lines.append(f"training: 0 dropped patches and rows in all {n_steps} steps; mean loss of "
                 f"the first {N_VIEWS} steps {first:.5f}, of the last {N_VIEWS} {last:.5f}")
    lines.append(f"train step: median {med:.3f} ms, p80 {p80:.3f} ms over {TRAIN_STEPS} steps "
                 f"after {TRAIN_WARM} warm -> {n_pix / (med / 1e3) / 1e6:.3f} Mpix/s fwd+bwd at "
                 f"the median")
    counter = [n_steps]

    def step_once():
        i = counter[0]
        counter[0] += 1
        step(pool, state, stats, cams[i % N_VIEWS], gts[i % N_VIEWS])

    lines += phase_profile("step", step_once, float(med), STEP_GROUPS, again=False)[1]
    return launches, lines, (pool, cams, gts, cfg)


def phase_step_compare(pool, cam, gt, cfg):
    """One step from one state: the kernel step against the all-plain step,
    and two kernel steps against each other (bit-equal)."""
    torch.cuda.reset_peak_memory_stats()
    loss, grads, aux = loss_and_grads(pool, cam, gt, cfg)
    torch.cuda.synchronize()
    peak_k = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_p, grads_p, aux_p = loss_and_grads(pool, cam, gt, dataclasses.replace(cfg, backend="tiled"))
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated()
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    lines = [f"kernel step vs all-plain step (view 0): loss {float(loss):.7f} vs "
             f"{float(loss_p):.7f} (rel {rel:.2e}); peak memory {peak_k / 2**30:.2f} GiB kernel, "
             f"{peak_p / 2**30:.2f} GiB all-plain"]
    require(rel <= STEP_LOSS_RTOL, "the kernel step's loss differs from the all-plain step's")
    _, check_lines = group_check("  step gradients", list(grads),
                                 [grads[k] for k in grads], [grads_p[k] for k in grads], STEP_REL)
    lines += check_lines
    bn, bn_p = aux["binning"], aux_p["binning"]
    same = all(torch.equal(bn[k], bn_p[k]) for k in
               ("patch_gsid", "tile_cnt", "total", "n_dropped", "total_rows", "rows_dropped",
                "gsid_counts"))
    lines.append(f"  binning and binfo equal to the all-plain step's: {same}")
    require(same, "the kernel step's binning differs from the all-plain step's")
    _, grads2, _ = loss_and_grads(pool, cam, gt, cfg)
    equal = all(torch.equal(grads[k], grads2[k]) for k in grads)
    lines.append(f"determinism: two kernel steps from one state give bit-equal gradients: {equal}")
    require(equal, "two kernel steps from one state differ")
    return lines


class _Keeper:
    """Stands in for a kernel wrapper in its module: calls it and keeps its
    arguments (detached, so that a plain version builds no graph on them)
    and result. The wrapper counts its launches under its module name, which
    now names this object, so ``launches`` reads and writes the wrapper's."""

    def __init__(self, fn, seen):
        self.fn, self.seen = fn, seen

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
        self.seen.setdefault(self.fn.__name__, []).append((args, kwargs, out))
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


def kept_calls(sites, run):
    """Runs ``run()`` with each wrapper of ``sites`` ((module, name) pairs)
    bound to a _Keeper under its module name, so the kernels can later be
    held to their plain versions on exactly what the run gave them. Returns
    (run's result, {wrapper name: [(args, kwargs, result), ...]})."""
    seen = {}
    originals = [getattr(mod, name) for mod, name in sites]
    for (mod, name), fn in zip(sites, originals):
        setattr(mod, name, _Keeper(fn, seen))
    try:
        out = run()
    finally:
        for (mod, name), fn in zip(sites, originals):
            setattr(mod, name, fn)
    return out, seen


def step_inputs(pool, cam, gt, cfg):
    """What K2, K5 and K6 receive in one kernel step from ``cam``. Returns
    {wrapper name: (args, kwargs, result)}."""
    sites = ((preprocess, "preprocess_bwd"), (rasterize, "rasterize_bwd"),
             (scan, "segmented_cumsum"))
    _, seen = kept_calls(sites, lambda: loss_and_grads(pool, cam, gt, cfg))
    require(sorted(seen) == sorted(name for _, name in sites),
            f"the step called only {sorted(seen)} of the backward kernels")
    return {k: v[-1] for k, v in seen.items()}


def group_check(label, names, got, want, rel):
    """Each group of ``got`` against ``want`` within rel * max|want| of the
    group (at least REL_FLOOR); and the same limit on planted faults, each
    group in turn zeroed and negated, which it must refuse. Returns (worst
    error, lines); raises, with the lines, when a sound group fails or a
    planted fault passes."""
    parts, worst, ok, n_caught, n_planted = [], 0.0, True, 0, 0
    for name, a, b in zip(names, got, want):
        scale = float(b.abs().max())
        limit = max(rel * scale, REL_FLOOR)
        err = float((a - b).abs().max())
        worst = max(worst, err)
        ok = ok and err <= limit and bool(torch.isfinite(a).all())
        parts.append(f"{name} {err:.2e} ({err / max(scale, REL_FLOOR):.1e} of max|want| "
                     f"{scale:.2e})")
        for fault in (torch.zeros_like(a), -a):
            n_planted += 1
            n_caught += float((fault - b).abs().max()) > limit
    lines = [f"{label}: max_abs_err, limit {rel:g} of each group's max|want|: "
             + ", ".join(parts),
             f"{label}: planted faults the limit refuses (each group zeroed, each negated): "
             f"{n_caught} of {n_planted}"]
    require(ok, f"{label} differ beyond the limit\n" + "\n".join(lines))
    require(n_caught == n_planted, f"{label}: a planted fault passes\n" + "\n".join(lines))
    return worst, lines


def phase_k2(seen, flush, clock_mhz, n_sm):
    args, kwargs, _ = seen["preprocess_bwd"]
    got = preprocess.preprocess_bwd(*args, **kwargs)
    want = preprocess.preprocess_bwd_plain(*args, **kwargs)
    worst, lines = group_check("K2 on the step's inputs",
                               ("pws", "shs", "alphas", "scales", "rots"), got, want, KERNEL_REL)
    timing = timings(lambda: preprocess.preprocess_bwd(*args, **kwargs),
                     lambda: preprocess.preprocess_bwd_plain(*args, **kwargs),
                     clock_mhz, flush)
    n = args[0].shape[0]
    n_par = 3 + SH_COLS + 1 + 3 + 4
    nbytes = n * 4 * (2 * n_par + preprocess.TABLE_COLS)  # params and cotangent in, grads out
    deg = round((args[1].shape[1] // 3) ** 0.5) - 1
    info = preprocess.kernel_info("bwd", deg)
    blocks = -(-n // info["threads"])
    lines.append(
        f"K2 as compiled (SH degree {deg}): {info['registers']} registers a thread, "
        f"{info['shared_bytes']} shared bytes a block of {info['threads']} threads, "
        f"{info['local_bytes']} local (spill) bytes a thread, {info['blocks_per_sm']} resident "
        f"blocks an SM; the step's {n} gaussians are {blocks} blocks, "
        f"{blocks / (info['blocks_per_sm'] * n_sm):.2f} waves on {n_sm} SMs")
    require(info["local_bytes"] == 0, f"K2 spills {info['local_bytes']} bytes a thread")
    # the epoch driver runs K2 over its whole capacity: the step's inputs
    # repeated up to DRIVER_CAPACITY gaussians
    reps = DRIVER_CAPACITY // n
    big = [torch.cat([a] * reps) for a in args[:6]]
    ms_big = event_ms(lambda: preprocess.preprocess_bwd(*big, *args[6:], **kwargs), clock_mhz,
                      flush=flush)
    bound_big = bound(nbytes * reps, n * reps * 600, 0, clock_mhz, n_sm)["bound_ms"]
    lines.append(f"K2 at the epoch driver's capacity, {n * reps} gaussians: {ms_big:.4f} ms "
                 f"by CUDA events, bound {bound_big:.4f} ms by bytes")
    return {"name": "K2 preprocess_bwd", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/preprocess_bwd.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/preprocess.py:180",
            "max_abs_err": worst, **timing,
            # ~600 FP32 operations per gaussian, an estimate: the bytes bound
            # K2 more than tenfold over it
            **bound(nbytes, n * 600, 0, clock_mhz, n_sm)}, lines


def blend_constant(name):
    """A float constant of csrc/blend.cuh, the kernels' own value."""
    text = (ROOT / "easygaussiansplatting_tpu_torch" / "csrc" / "blend.cuh").read_text()
    return float(re.search(rf"constexpr float {name} = ([-+0-9.eE]+)f;", text).group(1))


def blend_work(table, patch_gsid, tile_start, tile_cnt, walk):
    """What K4's or K5's walk does on this data, counted with the plain
    evaluation of alpha' (ops/blend.chunk_alpha); ``walk`` [H, W] is each
    pixel's walked length (K4: k4_walk; K5: contrib), the pairs at positions
    below it are evaluated. Counts: ``evaluated`` pairs; of those ``passed``
    the cutoff of csrc/blend.cuh (alpha' >= ALPHA_SKIP * 2^-CUTOFF_MARGIN:
    they take the exponential), ``live`` (alpha' >= ALPHA_SKIP),
    ``unclamped`` (and alpha' < ALPHA_CLAMP), ``moments`` (and maha > 0);
    ``entry_tile``: positions below each tile's largest walk; per warp of
    the kernels (16x8 pixels, two a tile) ``warp_iters``, the positions
    below its largest walk, and ``warp_live``, the (entry, warp) pairs with
    a live pair (K5's reductions)."""
    dev = table.device
    gx, gy = num_tiles(WIDTH, HEIGHT)
    walk_t = torch.zeros((gy * TILE, gx * TILE), dtype=torch.int64, device=dev)
    walk_t[:HEIGHT, :WIDTH] = walk
    walk_t = walk_t.reshape(gy, TILE, gx, TILE).transpose(1, 2).reshape(gx * gy, TILE * TILE)
    maxc = torch.minimum(walk_t.amax(1), tile_cnt.long())
    t = torch.arange(gx * gy, device=dev)
    origin = torch.stack([(t % gx) * TILE, (t // gx) * TILE], dim=1).float()
    lin = torch.arange(TILE * TILE, device=dev)
    px, py = (lin % TILE).float(), (lin // TILE).float()
    k_off = torch.arange(K_CHUNK, device=dev)
    edge = ALPHA_SKIP * 2.0 ** -blend_constant("CUTOFF_MARGIN")
    names = ("evaluated", "passed", "live", "unclamped", "moments", "warp_live")
    counts = torch.zeros(len(names), dtype=torch.int64, device=dev)
    for c in range(-(-int(maxc.max()) // K_CHUNK)):
        pos = c * K_CHUNK + k_off[None, :]  # [1, K]
        idx = torch.clamp(tile_start[:, None].long() + pos, 0, patch_gsid.numel() - 1)
        ok = (pos < maxc[:, None]) & (patch_gsid[idx] >= 0)  # [T, K]
        row = table[patch_gsid[idx].clamp(min=0).long()]  # [T, K, TABLE_COLS]
        ap, (_, _, maha) = chunk_alpha(row[..., 0:2] - origin[:, None, :], row[..., 2:5],
                                       row[..., 5], ok, px, py)
        evaluated = pos[..., None] < walk_t[:, None, :]  # [T, K, P]
        live = evaluated & (ap >= ALPHA_SKIP)
        unclamped = live & (ap < ALPHA_CLAMP)
        tk = live.shape[:2]
        counts += torch.stack([evaluated.sum(), (evaluated & (ap >= edge)).sum(), live.sum(),
                               unclamped.sum(), (unclamped & (maha > 0)).sum(),
                               live.reshape(*tk, 2, -1).any(-1).sum()])
    work = dict(zip(names, (int(v) for v in counts)))
    work["entry_tile"] = int(maxc.sum())
    work["warp_iters"] = int(torch.minimum(walk_t.reshape(gx * gy, 2, -1).amax(-1),
                                           tile_cnt.long()[:, None]).sum())
    return work


def k4_bound(nbytes, work, clock_mhz, n_sm):
    """K4's bound from blend_work's counts, with the FP32 operations and MUFU
    results counted from csrc/rasterize_fwd.cu and csrc/blend.cuh, for the
    pairs the data needs: an exponential only where blend.cuh's cutoff
    passes (the kernel takes one for every pair it walks, branch-free).
    evaluated: the quad's four offsets (1 a pixel), the exponent 5, the
    stop and skip compares 2; passed: min(e, 0), * alpha, the 0.99 clamp 3,
    and one ex2; live: tau * alpha' 1, the colours 3, 1 - alpha' and the
    tau product 2."""
    ops = work["evaluated"] * 8 + work["passed"] * 3 + work["live"] * 6
    return bound(nbytes, ops, work["passed"], clock_mhz, n_sm)


def k5_bound(nbytes, work, clock_mhz, n_sm):
    """K5's bound from blend_work's counts, with the FP32 operations and MUFU
    results counted from csrc/rasterize_bwd.cu and csrc/blend.cuh (a
    division as a reciprocal and a multiply, the least it costs)."""
    # evaluated: the offsets 1, the exponent 5, the cutoff and skip compares
    # 2; passed: as K4 (3 and one ex2).
    # live: 1 - alpha' and its clamp 2, the tau product 1, tau*alpha' 1,
    # g.c 3, d alpha' 2, the behind sum 1, the clamp compare 1, the three
    # colour terms 3; one reciprocal.
    # unclamped: d alpha' * alpha' and its sum 2, the maha compare 1.
    # maha > 0: d maha 1, dm*dx and dm*dy 2, the five moment sums 5.
    # (entry, warp) with a live pair: the reduce-scatter's 12 adds.
    # (entry, tile): the two warps' sums 9, the gradients from them (rows
    # 0, 1 and 3: 10; the max 1) and a division 1; one reciprocal.
    ops = (work["evaluated"] * 8 + work["passed"] * 3 + work["live"] * 14
           + work["unclamped"] * 3 + work["moments"] * 8 + work["warp_live"] * 12
           + work["entry_tile"] * 21)
    mufu = work["passed"] + work["live"] + work["entry_tile"]
    return bound(nbytes, ops, mufu, clock_mhz, n_sm)


def phase_k5(seen, flush, clock_mhz, n_sm):
    args, kw, _ = seen["rasterize_bwd"]
    table, patch_gsid, tile_start, tile_cnt, _, _, contrib = args
    got = rasterize.rasterize_bwd(*args, **kw)
    want = rasterize.rasterize_bwd_plain(*args, **kw)
    worst, lines = group_check("K5 on the step's inputs",
                               ("ux", "uy", "ca", "cb", "cc", "alpha", "r", "g", "b"),
                               got, want, KERNEL_REL)
    timing = timings(lambda: rasterize.rasterize_bwd(*args, **kw),
                     lambda: rasterize.rasterize_bwd_plain(*args, **kw),
                     clock_mhz, flush, plain_iters=3)
    work = blend_work(table, patch_gsid, tile_start, tile_cnt, contrib)
    lines.append("K5 work this data needs: (entry, pixel) pairs evaluated {evaluated}, past the "
                 "cutoff {passed}, live {live}, unclamped {unclamped}, with maha > 0 {moments}; "
                 "(entry, tile) steps {entry_tile}".format(**work))
    lines.append(
        f"K5 cross-pixel reduction: {K5_SHUFFLES} shuffles per (entry, warp) with a live pair, "
        f"{2 * K5_SHUFFLES} per (entry, tile) at most; this data: {work['warp_live']} such "
        f"(entry, warp) steps, {K5_SHUFFLES * work['warp_live']} shuffles")
    lines.append(kernel_info_line("K5", "bwd"))
    loop = sass_loop("rasterize_bwd_kernel")
    lines.append(f"K5 compiled inner loop (cuobjdump -sass): {loop[0]} instructions an "
                 f"(entry, warp) step, {loop[1]} of them shuffles")
    require(loop[1] == K5_SHUFFLES,
            f"K5's inner loop compiles to {loop[1]} shuffles, the design has {K5_SHUFFLES}")
    kept = int(tile_cnt.sum())
    n_distinct = int(torch.unique(patch_gsid[:kept]).numel()) if kept else 0
    m = patch_gsid.numel()
    n_pix = WIDTH * HEIGHT
    nbytes = kept * 4 + tile_cnt.numel() * 8 + n_distinct * 9 * 4 + n_pix * 5 * 4 + 9 * 4 * m
    return {"name": "K5 rasterize_bwd", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/rasterize_bwd.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/kernels.py:260",
            "max_abs_err": worst, **timing, **k5_bound(nbytes, work, clock_mhz, n_sm)}, lines


def k6_check(svals, flags, got):
    """K6's result against its plain version: (max abs error, elements
    beyond K6_RTOL of the running sum of |x|)."""
    want = scan.segmented_cumsum_plain(svals, flags)
    mag = scan.segmented_cumsum_plain(svals.abs(), flags)
    err = (got - want).abs()
    return float(err.max()), int((err > K6_RTOL * mag + 1e-12).sum())


def phase_k6(seen, flush, clock_mhz, n_sm):
    (svals, flags), _, _ = seen["segmented_cumsum"]
    got = scan.segmented_cumsum(svals, flags)
    worst, n_bad = k6_check(svals, flags, got)
    lines = [f"K6 on the step's sorted rows {tuple(svals.shape)}, {int(flags.sum())} segments: "
             f"max_abs_err {worst:.3e}, beyond {K6_RTOL}*running|sum|: {n_bad}"]
    require(n_bad == 0, "K6 differs from its plain version beyond tolerance")
    r, m = svals.shape
    plan = scan.segmented_cumsum_plan(m, r)
    kernels = require_kernel_count("K6 on the step's rows",
                                   lambda: scan.segmented_cumsum(svals, flags), plan["launches"])
    lines.append(f"K6 plan (egs_segmented_cumsum_plan): tiles of {plan['tile']} positions, "
                 f"{-(-m // plan['tile'])} tiles, {plan['launches']} kernel launch(es) and "
                 f"{plan['memsets']} memset a call, {plan['scratch']} scratch words; device "
                 f"kernels per call {kernels}")
    # bit-equal calls: on the step's rows, and with one segment from
    # position `a` over more than three tiles
    tile = plan["tile"]
    a = tile // 2 + 7
    long_flags = flags.clone()
    long_flags[a] = 1
    long_flags[a + 1:a + 3 * tile + 100] = 0
    for label, f in (("the step's rows", flags), ("a segment over 4 tiles", long_flags)):
        first = got if f is flags else scan.segmented_cumsum(svals, f)
        equal = torch.equal(first, scan.segmented_cumsum(svals, f))
        err, bad = k6_check(svals, f, first)
        lines.append(f"K6 twice on {label}: bit-equal {equal}; max_abs_err {err:.3e}, beyond "
                     f"{K6_RTOL}*running|sum|: {bad}")
        require(equal and bad == 0, f"K6 on {label}: two calls differ or a value is off")
    # the yardstick for the whole reduce (sort, K6, gathers): one index_add_
    # of the same per-patch rows onto the gaussians; the port never calls it
    (table, gsid, *_), _, rows = seen["rasterize_bwd"]
    n = table.shape[0]
    idx = torch.where(gsid >= 0, gsid, n).long()
    rows_t = rows.T.contiguous()
    timing = timings(lambda: scan.segmented_cumsum(svals, flags),
                     lambda: scan.segmented_cumsum_plain(svals, flags), clock_mhz, flush,
                     library=lambda: torch.zeros((n + 1, 9), device=rows_t.device).index_add_(
                         0, idx, rows_t))
    return {"name": "K6 segmented_cumsum", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/seg_scan.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/scan.py:74",
            "max_abs_err": worst, **timing,
            **bound(m * (9 * 4 * 2 + 4), svals.numel(), 0, clock_mhz, n_sm)}, lines


@contextlib.contextmanager
def env_flags(flags):
    """Set the EGS_* flags in os.environ for the block; restore them after."""
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_launches():
    for w in WRAPPERS.values():
        w.launches = 0


def phase_routes(pool, cam, gt, cfg):
    """One kernel step on ``cam`` under each sort route, from one state,
    held against the default route at the same budget: binning and
    gsid_counts equal; gradients bit-equal under K8 (a stable sort: the sums
    run in the same order), each group within ROUTE_REL * max|g| under K7,
    with planted faults refused; the route's kernel launched, and neither
    sort kernel on the default route. Returns ({route label: launches},
    {wrapper name: [(label, args, kwargs, result)]}, lines)."""
    sites = ((sort, "sort_pairs"), (radix, "counting_sort"))
    default, route_launches, calls, lines = {}, {}, {}, []
    for label, flags, budget, kernel in ROUTES:
        rcfg = cfg if budget is None else dataclasses.replace(cfg, max_patches=budget)
        if rcfg.max_patches not in default:
            reset_launches()
            default[rcfg.max_patches] = loss_and_grads(pool, cam, gt, rcfg)
            torch.cuda.synchronize()
            ran = {k: WRAPPERS[k].launches for k in ROUTE_KERNELS}
            lines.append(f"default route at max_patches {rcfg.max_patches}: sort-route kernel "
                         f"launches {ran}")
            require(all(v == 0 for v in ran.values()), "a sort-route kernel ran by default")
        loss_d, grads_d, aux_d = default[rcfg.max_patches]
        reset_launches()
        with env_flags(flags):
            (loss, grads, aux), seen = kept_calls(
                sites, lambda rcfg=rcfg: loss_and_grads(pool, cam, gt, rcfg))
        torch.cuda.synchronize()
        launches = {k: WRAPPERS[k].launches for k in ROUTE_KERNELS}
        route_launches[label] = launches
        for name, kept in seen.items():
            calls.setdefault(name, []).extend((label, *c) for c in kept)
        bn, bn_d = aux["binning"], aux_d["binning"]
        same_bins = all(torch.equal(bn[k], bn_d[k]) for k in BIN_KEYS)
        bit_equal = bool(torch.equal(loss, loss_d)) and all(
            torch.equal(grads[k], grads_d[k]) for k in grads)
        lines.append(f"route {label} {flags} (max_patches {rcfg.max_patches}): launches "
                     f"{launches}; binning and gsid_counts equal to the default route: "
                     f"{same_bins}; loss and gradients bit-equal: {bit_equal}")
        require(launches[kernel] > 0, f"route {label}: {kernel} was not launched")
        require(all(v == 0 for k, v in launches.items() if k != kernel),
                f"route {label}: another sort kernel ran: {launches}")
        require(same_bins, f"route {label}: binning differs from the default route")
        if kernel.startswith("K8"):
            require(bit_equal, f"route {label}: gradients differ from the default route")
        else:
            _, check = group_check(f"  route {label} gradients", list(grads),
                                   [grads[k] for k in grads], [grads_d[k] for k in grads],
                                   ROUTE_REL)
            lines += check
    return route_launches, calls, lines


def _words(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def sorted_pairs(cols):
    """The (key words, payload) rows sorted lexicographically, as columns
    (floats by their bits): equal lists mean equal multisets of rows."""
    words = [_words(c) for c in cols]
    order = torch.arange(words[0].numel(), device=words[0].device)
    for w in reversed(words):
        order = order[torch.sort(w[order], stable=True).indices]
    return [w[order] for w in words]


def library_sort(keys, vals, n_keys):
    """One stable torch.sort on the key (two words as one int64) and a
    gather of every array: the yardstick of K7 and K8."""
    comp = keys if n_keys == 1 else (keys.long() << 32) + (vals[0].long() + 2**31)
    perm = torch.sort(comp, stable=True).indices
    return [a[perm] for a in (keys, *vals)]


def sum_timings(parts):
    """The times and bounds of several calls added up (bound_by: the
    first's; every part here is bound by bytes)."""
    return {k: v if isinstance(v, str) else sum(p[k] for p in parts)
            for k, v in parts[0].items()}


def device_kernels(fn):
    """The device kernels one call of fn() launches (profiled after a warm
    call): (their count, "N: name xk t us, ..." in launch order with their
    device time in that call), or (None, "not traced") where the profiler
    records no device activity. A small flush kernel, which the count leaves
    out, runs first in the profile, so that the call's first kernel is not
    the profile's first activity. Memsets (K3 and K6 clear their look-back
    words with one) are device work but not kernels: the count leaves them
    out and the text names them."""
    fn()
    torch.cuda.synchronize()
    marker = torch.zeros(256, dtype=torch.int32, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        marker.bitwise_not_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = sorted(_kernel_events(prof), key=lambda e: e.time_range.start)
    if not events:
        return None, "not traced"
    by_name = {}
    for e in events:
        n, us = by_name.get(short_name(e.name), (0, 0.0))
        by_name[short_name(e.name)] = (n + 1, us + e.time_range.elapsed_us())
    counted = sum(not e.name.startswith("Memset") for e in events)
    return counted, f"{counted}: " + ", ".join(
        f"{name} x{n} {us:.1f} us" for name, (n, us) in by_name.items())


KERNEL_COUNT_TRIES = 3


def require_kernel_count(label, fn, expected):
    """The device kernels of one call of fn(), which must number ``expected``
    (the design's launches). A launch that fails raises in fn(), so a call
    cannot run fewer kernels than it launched without failing; a profile that
    holds fewer has lost an activity record, and is taken again, up to
    KERNEL_COUNT_TRIES profiles. More kernels than the design's, or fewer in
    every profile, fail. Returns the text for the phase's line."""
    short = []
    for _ in range(KERNEL_COUNT_TRIES):
        counted, kernels = device_kernels(fn)
        require(counted is not None, f"{label}: the profiler recorded no device kernel")
        require(counted <= expected, f"{label}: {kernels} device kernels in one call, "
                f"the design launches {expected}")
        if counted == expected:
            return kernels + "".join(f" (an earlier profile traced {k})" for k in short)
        short.append(kernels)
    require(False, f"{label}: the design launches {expected} device kernels a call; "
            f"{KERNEL_COUNT_TRIES} profiles traced " + "; ".join(short))


def max_abs_diff(got, want):
    """The largest elementwise |got - want| over lists of arrays (int32 words
    and float32 values, compared in float64)."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in zip(got, want))


def phase_k7(calls, flush, clock_mhz, n_sm):
    """K7 against its plain version on every call its routes made: keys
    equal, (key, payload) rows equal as multisets. The entry's times are
    those of the calls of one step on the route K7 in the gsid_counts
    inversion and the reduce; the other routes' calls are timed in lines.
    Every call's sorted arrays must equal the stable plain version's bit for
    bit, and a repeat call's too; the entry's max_abs_err is the largest
    elementwise difference from the plain version over every call."""
    lines, entry_parts, worst = [], [], 0.0
    for label, args, kw, out in calls:
        keys, vals = args[0], args[1:]
        n_keys = kw.get("n_keys", 1)
        want = sort.sort_pairs_plain(*args, **kw)
        again = sort.sort_pairs(*args, **kw)
        same_keys = all(torch.equal(out[j], want[j]) for j in range(n_keys))
        same_pairs = all(torch.equal(a, b) for a, b in
                         zip(sorted_pairs(out), sorted_pairs(want)))
        exact = all(torch.equal(_words(a), _words(b)) for a, b in zip(out, want))
        repeat = all(torch.equal(_words(a), _words(b)) for a, b in zip(out, again))
        require(same_keys and same_pairs and exact and repeat,
                f"K7 on {label} differs from its stable plain version")
        worst = max(worst, max_abs_diff(out, want))
        m = keys.numel()
        # a CTA sort, one merge pass per level, a gather of the payloads
        kernels = require_kernel_count(
            f"K7 on {label}", lambda: sort.sort_pairs(*args, **kw),
            sort.kernel_plan(m, n_keys)[0] + 1 + (len(vals) > n_keys - 1))
        t = timings(lambda: sort.sort_pairs(*args, **kw),
                    lambda: sort.sort_pairs_plain(*args, **kw), clock_mhz, flush,
                    plain_iters=20, library=lambda: library_sort(keys, vals, n_keys))
        t.update(bound(m * 4 * 2 * (1 + len(vals)), 0, 0, clock_mhz, n_sm))
        lines.append(f"K7 on {label}, {m} keys x {n_keys} word(s) + {len(vals) + 1 - n_keys} "
                     f"payload(s): equal to the stable plain version, and on a repeat call; "
                     f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                     f"library {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ms); device "
                     f"kernels per call {kernels}")
        if label == ROUTES[1][0]:
            entry_parts.append(t)
    require(len(entry_parts) == 2, "the inversion-and-reduce route made two K7 calls")
    return {"name": "K7 sort_pairs", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/sort.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/sort.py:90",
            "max_abs_err": worst, **sum_timings(entry_parts)}, lines


def phase_k8(calls, flush, clock_mhz, n_sm):
    """K8 against its plain version on binning's and the reduce's calls:
    equal bit for bit, and on a repeat call. The entry's times are the two
    calls' of one step; its max_abs_err is the largest elementwise
    difference from the plain version over both."""
    lines, parts, worst = [], [], 0.0
    for label, args, kw, out in calls:
        want = radix.counting_sort_plain(*args, **kw)
        again = radix.counting_sort(*args, **kw)
        exact = all(torch.equal(a, b) for a, b in zip(out, want))
        repeat = all(torch.equal(a, b) for a, b in zip(again, want))
        require(exact and repeat, f"K8 on {label} differs from its plain version")
        worst = max(worst, max_abs_diff(out, want))
        m = args[0].numel()
        # an upfront histogram, one scatter per pass, a gather of the payloads
        kernels = require_kernel_count(
            f"K8 on {label}", lambda: radix.counting_sort(*args, **kw),
            radix.kernel_plan(m, kw["key_bound"])[0] + 1 + (len(args) > 1))
        t = timings(lambda: radix.counting_sort(*args, **kw),
                    lambda: radix.counting_sort_plain(*args, **kw), clock_mhz, flush,
                    plain_iters=20, library=lambda: library_sort(args[0], args[1:], 1))
        t.update(bound(m * 4 * 2 * len(args), 0, 0, clock_mhz, n_sm))
        lines.append(f"K8 on {label}, {m} keys below {kw['key_bound']} + {len(args) - 1} "
                     f"payload(s): equal to the plain version; {t['ms']:.4f} ms (plain "
                     f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
                     f"{t['bound_ms']:.4f} ms); device kernels per call {kernels}")
        parts.append(t)
    require(len(parts) == 2, "the K8 route made two K8 calls")
    return {"name": "K8 counting_sort", "route": "cuda",
            "source": "easygaussiansplatting_tpu_torch/csrc/radix.cu",
            "replaces": "easygaussiansplatting_tpu/ops/pallas/radix.py:100",
            "max_abs_err": worst, **sum_timings(parts)}, lines


def sums_check(label, got, want, mag, rtol):
    """``got`` against ``want`` within ``rtol`` of ``mag`` (the sum of |x|
    behind each value), and a planted fault, the value with the largest mag
    moved by PLANTED of it, which the same limit must refuse. Returns (max
    abs error, line); raises when a value fails or the fault passes."""
    err = (got - want).abs()
    limit = rtol * mag
    n_bad = int((err > limit).sum()) + int((~torch.isfinite(got)).sum())
    j = int(torch.argmax(mag))
    fault = got.flatten().clone()
    fault[j] += PLANTED * mag.flatten()[j]
    caught = float((fault[j] - want.flatten()[j]).abs()) > float(limit.flatten()[j])
    worst = float(err.max())
    line = (f"{label}: max_abs_err {worst:.3e}, beyond {rtol:g}*sum|x|: {n_bad}; a value moved "
            f"by {PLANTED:g} of its sum|x| refused: {caught}")
    require(n_bad == 0, line)
    require(caught, f"a planted fault passes: {line}")
    return worst, line


def probe_launches(run):
    """The launch counts of one probe's path: every count set to 0 just
    before ``run()`` and read just after. Returns (run's result, counts)."""
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in WRAPPERS.items() if w.launches}


def phase_k9(device, flush, clock_mhz, n_sm):
    """K9: the probe's path (micro_bench.run at the script's sizes, which
    prints its A, B, V and D1-D5 times), then each kernel held against its
    plain version on the script's inputs and timed with the L2 flushed."""
    lines = ["K9 probe path (probes.micro_bench.run):"]
    _, launches = probe_launches(lambda: micro_bench.run(device))
    lines.append(f"K9 probe path launches: {launches}")
    require(sorted(launches) == sorted(K9_KERNELS), f"K9 launches {launches}")
    q, nt, k = micro_bench.Q_TOTAL, micro_bench.N_TILES, micro_bench.K
    packed, tiles, _ = micro_bench.make_inputs(device)
    per_tile = torch.bincount(tiles.long(), minlength=nt)
    lines.append(f"K9 inputs: packed {tuple(packed.shape)}, {q} chunks over {nt} tiles, "
                 f"{q / nt:.3f} chunks per tile, at most {int(per_tile.max())}, "
                 f"{int((per_tile == 0).sum())} tiles with none")
    a = micro_bench.variant_a(q, packed, tiles)
    img, tau = micro_bench.variant_b(q, nt, packed, tiles)
    v = micro_bench.variant_vmem_resident(q, nt, packed, tiles)
    torch.cuda.synchronize()
    img_p, tau_p = micro_bench.variant_b_plain(q, nt, packed, tiles)
    v_p = micro_bench.variant_vmem_resident_plain(q, nt, packed, tiles)
    require(torch.equal(a, torch.zeros_like(a)), "K9a did not return zeros")
    require(torch.equal(tau, tau_p), "K9b tau is not all ones")
    err_b, line_b = sums_check("K9b img", img, img_p, micro_bench.variant_b_plain(
        q, nt, packed.abs(), tiles)[0], K9_RTOL)
    err_v, line_v = sums_check("K9v", v, v_p, micro_bench.variant_vmem_resident_plain(
        q, nt, packed.abs(), tiles), K9_RTOL)
    lines += [f"K9a: [8, 128] zeros, exact; K9b tau all ones, exact; K9b img bit-equal to the "
              f"plain version: {torch.equal(img, img_p)}", line_b, line_v]

    chunks = packed[:3].reshape(3, q, k).transpose(0, 1).contiguous()
    tl = tiles.long()
    rows_t = packed[:3].T.contiguous()
    lens = per_tile * k
    read3 = 3 * q * k * 4
    specs = (
        ("K9a variant_a", lambda: micro_bench.variant_a(q, packed, tiles),
         lambda: micro_bench.variant_a_plain(q, packed, tiles), None,
         packed.numel() * 4 + a.numel() * 4, 0, 0.0, ":41"),
        ("K9b variant_b", lambda: micro_bench.variant_b(q, nt, packed, tiles),
         lambda: micro_bench.variant_b_plain(q, nt, packed, tiles),
         lambda: torch.zeros((nt, 3, k), device=device).index_add_(0, tl, chunks),
         read3 + q * 4 + (img.numel() + tau.numel()) * 4, 3 * q * k, err_b, ":61"),
        ("K9v variant_vmem_resident", lambda: micro_bench.variant_vmem_resident(q, nt, packed, tiles),
         lambda: micro_bench.variant_vmem_resident_plain(q, nt, packed, tiles),
         lambda: torch.segment_reduce(rows_t, "sum", lengths=lens, unsafe=True),
         read3 + q * 4 + v.numel() * 4, 3 * q * k, err_v, ":93"),
    )
    entries = []
    for name, kern, plain, library, nbytes, ops, err, line in specs:
        t = timings(kern, plain, clock_mhz, flush, library=library)
        t.update(bound(nbytes, ops, 0, clock_mhz, n_sm))
        entries.append({"name": name, "route": "cuda",
                        "source": "easygaussiansplatting_tpu_torch/csrc/micro_bench.cu",
                        "replaces": f"scripts/micro_bench.py{line}",
                        "launches": launches.get(name, 0), "max_abs_err": err, **t})
    ta, tb, tv = entries
    require(ta["ms"] >= ta["bound_ms"],
            f"K9a took {ta['ms']:.4f} ms, below its bytes bound {ta['bound_ms']:.4f} ms: the "
            f"loads that nothing reads were dropped")
    for t in (tb, tv):
        require(t["ms"] >= t["bound_ms"], f"{t['name']} took {t['ms']:.4f} ms, below its bytes "
                f"bound {t['bound_ms']:.4f} ms")
    kern_b, kern_v = specs[1][1], specs[2][1]
    for label, variant, t in (("K9b", "b", tb), ("K9v", "vmem_resident", tv)):
        info = micro_bench.kernel_info(variant)
        blocks = -(-nt // info["tiles_per_block"])
        lines.append(f"{label} as compiled: a warp a tile, {info['tiles_per_block']} warp(s) a "
                     f"block, {blocks} blocks; {info['registers']} registers a thread, "
                     f"{info['shared_bytes']} shared bytes a block, {info['local_bytes']} spill "
                     f"bytes, {info['blocks_per_sm']} resident blocks an SM, so "
                     f"{blocks / (info['blocks_per_sm'] * n_sm):.2f} waves on {n_sm} SMs; "
                     f"{1e3 * (t['ms'] - t['bound_ms']):.2f} us over its bytes bound")
        require(info["local_bytes"] == 0, f"{label} spills {info['local_bytes']} bytes a thread")
    bulk = [o for o in (opcode(i) for _, i in sass_body("tile_sums_kernel"))
            if o.startswith(BULK_COPY_OPCODE)]
    lines.append(f"K9b compiled (cuobjdump -sass): bulk copies {bulk}")
    require(bulk, f"K9b's compiled kernel holds no {BULK_COPY_OPCODE} (bulk copy)")
    # the write flush of every card ms leaves dirty lines in the L2, which
    # K9b's misses write back: under a read-only flush its device time is
    # that of its own bytes
    read_us = ab.device_us(kern_b, ab.make_flush("read"))
    lines.append(f"K9b: {tb['ms']:.4f} ms by CUDA events under the write flush, "
                 f"{read_us:.2f} us of device time a call under a read-only flush (profiler), "
                 f"bound {1e3 * tb['bound_ms']:.2f} us")
    for label, kern in (("K9b", kern_b), ("K9v", kern_v)):
        lines.append(f"{label} device kernels per call: " + require_kernel_count(label, kern, 1))
    return entries, lines


def phase_k10(device, flush, clock_mhz, n_sm):
    """K10: the probe's path (exp_dma_stream.run at the script's sizes: its
    numpy check and its per-chunk time), then the kernel held against its
    plain version and timed with the L2 flushed; its bound counts the
    distinct rows of x the summed ranges cover."""
    lines = ["K10 probe path (probes.exp_dma_stream.run):"]
    (err_np, _), launches = probe_launches(lambda: exp_dma_stream.run(device))
    lines.append(f"K10 probe path launches: {launches}")
    require(list(launches) == ["K10 stream_sums"], f"K10 launches {launches}")
    require(err_np < exp_dma_stream.OK_TOL, f"K10 differs from numpy by {err_np}")
    x, offs, rows = (torch.from_numpy(t).to(device) for t in exp_dma_stream.make_inputs())
    m, q = x.shape[0], offs.shape[0]
    got = exp_dma_stream.stream_sums(offs, rows, x)
    torch.cuda.synchronize()
    want = exp_dma_stream.stream_sums_plain(offs, rows, x)
    err, line = sums_check("K10", got, want, exp_dma_stream.stream_sums_plain(offs, rows, x.abs()),
                           K10_RTOL)
    lines.append(line)
    # the rows the summed ranges cover, each counted once
    edges = torch.zeros(m + 1, dtype=torch.int32, device=device)
    edges.index_add_(0, offs.long(), torch.ones_like(offs))
    edges.index_add_(0, (offs + rows).long(), -torch.ones_like(offs))
    covered = int((torch.cumsum(edges, 0)[:m] > 0).sum())
    n_sum = int(rows.sum())
    idx = torch.repeat_interleave(offs.long(), rows.long()) + (
        torch.arange(n_sum, device=device) - torch.repeat_interleave(
            torch.cumsum(rows.long(), 0) - rows.long(), rows.long()))
    bag_off = torch.cumsum(rows.long(), 0) - rows.long()
    t = timings(lambda: exp_dma_stream.stream_sums(offs, rows, x),
                lambda: exp_dma_stream.stream_sums_plain(offs, rows, x), clock_mhz, flush,
                library=lambda: torch.nn.functional.embedding_bag(idx, x, bag_off, mode="sum"))
    t.update(bound(covered * 16 * 4 + q * 2 * 4 + got.numel() * 4, n_sum * 16, 0, clock_mhz,
                   n_sm))
    lines.append(f"K10: {q} chunks, {n_sum} rows summed, {covered} of {m} rows of x covered "
                 f"({covered * 64 / 1e6:.2f} MB); {1e6 * t['ms'] / q:.1f} ns a chunk, bound "
                 f"{1e6 * t['bound_ms'] / q:.1f} ns a chunk")
    require(t["ms"] >= t["bound_ms"],
            f"K10 took {t['ms']:.4f} ms, below its bytes bound {t['bound_ms']:.4f} ms")
    info = exp_dma_stream.kernel_info()
    blocks = -(-q // info["chunks_per_block"])
    lines.append(f"K10 as compiled: a ring of {info['stages']} stages, "
                 f"{info['chunks_per_block']} chunks a block, {blocks} blocks; "
                 f"{info['shared_bytes']} shared bytes and {info['registers']} registers a "
                 f"block / thread, {info['local_bytes']} spill bytes, {info['blocks_per_sm']} "
                 f"resident blocks an SM, so {blocks / (info['blocks_per_sm'] * n_sm):.2f} waves "
                 f"on {n_sm} SMs")
    ops = [opcode(i) for _, i in sass_body("stream_sums_kernel")]
    bulk = [o for o in ops if o.startswith(BULK_COPY_OPCODE)]
    lines.append(f"K10 compiled (cuobjdump -sass): {len(ops)} instructions, bulk copies "
                 f"{bulk}; barrier and async opcodes "
                 f"{sorted({o for o in ops if o.startswith(('SYNCS', 'UBLK', 'UTMA', 'FENCE'))})}")
    require(bulk, f"K10's compiled kernel holds no {BULK_COPY_OPCODE} (bulk copy)")
    lines.append("K10 device kernels per call: " + require_kernel_count(
        "K10", lambda: exp_dma_stream.stream_sums(offs, rows, x), 1))
    return [{"name": "K10 stream_sums", "route": "cuda",
             "source": "easygaussiansplatting_tpu_torch/csrc/dma_stream.cu",
             "replaces": "scripts/exp_dma_stream.py:25",
             "launches": launches.get("K10 stream_sums", 0), "max_abs_err": err, **t}], lines


def _generator_copy(gen):
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


def phase_driver(device, keep):
    """The epoch driver: ``train`` for DRIVER_EPOCHS epochs of the N_VIEWS
    views at capacity DRIVER_CAPACITY, densify every 2 epochs, the adaptive
    budget from the bench's patch budget (rung 589,824); a checkpoint and an
    in-memory copy of the state at epoch 2, and from each a resumed
    ``train(start_epoch=2)``, which must agree bit for bit. Yields its
    lines as it goes, so a failed check follows what led to it; leaves the
    final pool, the cameras, the ground truth and the config in ``keep``."""
    pool, cams, gts, scene_size, cfg = train_setup(device, capacity=DRIVER_CAPACITY)
    cfg = dataclasses.replace(cfg, epochs=DRIVER_EPOCHS, densify_every_epochs=2)
    ck = ROOT / "build" / "smoke_driver.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    rung = PatchBudget(cfg).value
    # each epoch's starting state and budget, for its device busy time below
    starts = [(copy.deepcopy((pool, adam_init(pool.params()),
                              density_stats_init(pool.capacity, device))), rung)]
    kept = {}

    def at_epoch(e, pool, adam, stats, gen, history):
        if e < DRIVER_EPOCHS:
            starts.append((copy.deepcopy((pool, adam, stats)), history["budget"][-1]))
        if e == 2:
            save_checkpoint(ck, pool, adam, stats, epoch=e, generator=gen)
            kept["state"], kept["gen"] = copy.deepcopy((pool, adam, stats)), _generator_copy(gen)

    logs = []
    reset_launches()
    t0 = time.perf_counter()
    pool, hist = train(pool, cams, gts, cfg, scene_size, seed=SEED, log_fn=logs.append,
                       eval_every=100, epoch_cb=at_epoch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    keep.update(pool=copy.deepcopy(pool), cams=cams, gts=gts, cfg=cfg)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    yield f"driver: {DRIVER_EPOCHS} epochs x {N_VIEWS} views in {wall:.3f} s; launches {launches}"
    yield from (f"  log: {ln}" for ln in logs)
    require(all(launches[k] > 0 for k in STEP_KERNELS), f"a kernel was not launched: {launches}")
    for e in range(DRIVER_EPOCHS):
        yield (f"  epoch {e + 1}: wall {hist['epoch_time'][e] * 1e3:.3f} ms (steps "
               f"{hist['t_steps_wall'][e] * 1e3:.3f} ms), t_step_device "
               f"{hist['t_step_device'][e] * 1e3:.3f} ms, densify "
               f"{hist['t_densify'][e] * 1e3:.3f} ms, budget {hist['budget'][e]}, n_alive "
               f"{hist['n_alive'][e]}, overflow_steps {hist['overflow_steps'][e]}, loss "
               f"{hist['loss'][e]:.6f}")
    for e in range(DRIVER_EPOCHS):
        before = hist["budget"][e - 1] if e else rung
        if hist["overflow_steps"][e] > 0:
            require(hist["budget"][e] != before,
                    f"epoch {e + 1} dropped patches and the budget did not change")
    # a densify adds gaussians as bright as their sources (the reference's
    # clone and split both keep the original), so the loss jumps after one;
    # between densifies it must fall
    for e in range(1, DRIVER_EPOCHS):
        if e % cfg.densify_every_epochs:
            require(hist["loss"][e] < hist["loss"][e - 1],
                    f"the loss did not fall from epoch {e} to {e + 1}: "
                    f"{hist['loss'][e - 1]:.6f} -> {hist['loss'][e]:.6f}")
    require(hist["n_alive"][1] > N_GAUSSIANS, "the densify at epoch 2 added nothing")

    rpool, radam, rstats, epoch, rgen = load_checkpoint(ck, device=device)
    require(epoch == 2 and rgen is not None, "the checkpoint is not epoch 2's")
    mpool, madam, mstats = kept["state"]
    quiet = dict(seed=SEED, log_fn=lambda *_: None, eval_every=100)
    _, rh = train(rpool, cams, gts, cfg, scene_size, adam_state=radam, stats=rstats,
                  start_epoch=2, generator=rgen, **quiet)
    _, mh = train(mpool, cams, gts, cfg, scene_size, adam_state=madam, stats=mstats,
                  start_epoch=2, generator=kept["gen"], **quiet)
    same = (rh["loss"] == mh["loss"] and radam.count == madam.count
            and all(torch.equal(getattr(rpool, k), getattr(mpool, k))
                    for k in ("pws", "low_shs", "high_shs", "alphas_raw", "scales_raw",
                              "rots_raw", "alive"))
            and all(torch.equal(radam.mu[k], madam.mu[k]) and torch.equal(radam.nu[k], madam.nu[k])
                    for k in radam.mu)
            and torch.equal(rstats.grad_accum, mstats.grad_accum)
            and torch.equal(rstats.cunt, mstats.cunt))
    yield (f"driver resume: train(start_epoch=2) from the epoch-2 checkpoint and from the "
           f"state kept in memory: pool, Adam state and stats bit-equal: {same}; losses "
           f"{[round(v, 6) for v in rh['loss']]}")
    require(same, "the resumed runs differ")

    # each epoch's idle share: the device's busy time per step, profiled
    # from the epoch's starting state at its starting budget, against the
    # epoch's step wall time
    shares = []
    for e, ((spool, sadam, sstats), budget) in enumerate(starts):
        step = make_train_step(cfg, scene_size, DRIVER_EPOCHS * N_VIEWS, max_patches=budget,
                               device=device)
        counter = [0]

        def step_once():
            i = counter[0]
            counter[0] += 1
            step(spool, sadam, sstats, cams[i % N_VIEWS], gts[i % N_VIEWS])

        wall_step = hist["t_steps_wall"][e] * 1e3 / N_VIEWS
        busy, prof = phase_profile(f"driver epoch {e + 1} step", step_once, wall_step,
                                   STEP_GROUPS, again=False)
        yield from prof[:1]
        if busy is not None:
            shares.append(f"epoch {e + 1} {1 - busy / wall_step:.3f}")
    yield ("driver idle share per epoch (1 - device busy per step from the epoch's starting "
           "state / the epoch's step wall per view): " + ", ".join(shares))


def phase_cli():
    out = ROOT / "build" / "smoke_cli.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():
        out.unlink()
    res = subprocess.run([sys.executable, "-m", "easygaussiansplatting_tpu_torch.render",
                          "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    require(res.returncode == 0, f"render CLI failed:\n{res.stdout}\n{res.stderr}")
    require(out.exists() and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", "CLI wrote no PNG")
    return [f"CLI: {res.stdout.strip().splitlines()[-1]}"]


def phase_train_cli():
    out = ROOT / "build" / "smoke_train"
    for name in ("final.ply", "checkpoint.npz"):
        if (out / name).exists():
            (out / name).unlink()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "easygaussiansplatting_tpu_torch.train",
                          "--synthetic", "--epochs", "2", "--out", str(out)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    require(res.returncode == 0, f"train CLI failed:\n{res.stdout}\n{res.stderr}")
    require((out / "final.ply").exists() and (out / "checkpoint.npz").exists(),
            "the train CLI wrote no final.ply or checkpoint.npz")
    return [f"train CLI ({time.perf_counter() - t0:.1f} s): " + line
            for line in res.stdout.strip().splitlines()[-3:]]


def phase_bench_cli():
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "easygaussiansplatting_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(res.returncode == 0, f"bench CLI failed:\n{res.stdout}\n{res.stderr}")
    lines = res.stdout.strip().splitlines()
    require(len(lines) == 1, f"bench printed {len(lines)} lines, not one")
    rec = json.loads(lines[0])
    require(all(k in rec for k in ("value", "fwd_throughput")), f"bench line lacks keys: {rec}")
    return [f"bench CLI ({time.perf_counter() - t0:.1f} s): {lines[0]}"]


FLAGS_OUT = ROOT / "build" / "smoke_train_flags"


def run_module(module, *args):
    """Runs ``python -m easygaussiansplatting_tpu_torch.<module> args``;
    returns its CompletedProcess and its seconds."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"easygaussiansplatting_tpu_torch.{module}",
                          *args], cwd=ROOT, capture_output=True, text=True, timeout=600)
    return res, time.perf_counter() - t0


def phase_train_cli_flags():
    """The train CLI for one epoch with --preview, --profile and
    --debug-nans: the preview PNG and the trace exist."""
    for f in (FLAGS_OUT / "preview0001.png", FLAGS_OUT / "profile" / "trace.json"):
        if f.exists():
            f.unlink()
    res, seconds = run_module("train", "--synthetic", "--epochs", "1", "--out", str(FLAGS_OUT),
                              "--preview", "--profile", str(FLAGS_OUT / "profile"),
                              "--debug-nans")
    require(res.returncode == 0, f"train CLI with flags failed:\n{res.stdout}\n{res.stderr}")
    png = FLAGS_OUT / "preview0001.png"
    require(png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n",
            "--preview wrote no PNG")
    trace = FLAGS_OUT / "profile" / "trace.json"
    require(trace.exists() and trace.stat().st_size > 0, "--profile wrote no trace")
    return [f"train CLI --preview --profile --debug-nans ({seconds:.1f} s): "
            f"{png.name} {png.stat().st_size} B, {trace.name} {trace.stat().st_size} B; "
            + res.stdout.strip().splitlines()[-1]]


def phase_eval_cli():
    """The eval CLI on the train CLI phase's final.npy: a finite mean PSNR."""
    res, seconds = run_module("eval", "--gs", str(ROOT / "build" / "smoke_train" / "final.npy"),
                              "--synthetic")
    require(res.returncode == 0, f"eval CLI failed:\n{res.stdout}\n{res.stderr}")
    last = res.stdout.strip().splitlines()[-1]
    found = re.match(r"mean over 8 views: psnr (\S+)", last)
    require(found is not None and np.isfinite(float(found.group(1))),
            f"eval CLI printed no finite mean PSNR: {last}")
    return [f"eval CLI on final.npy ({seconds:.1f} s): {last}"]


def phase_gate():
    """The gradient gate: exit 0, GATE_CHECKS [OK], no [NG]."""
    res, seconds = run_module("verify_gradients")
    n_ok, n_ng = res.stdout.count("[OK]"), res.stdout.count("[NG]")
    lines = [f"gradient gate ({seconds:.1f} s): exit {res.returncode}, {n_ok} [OK], {n_ng} [NG]"]
    lines += ["  " + ln for ln in res.stdout.splitlines() if "(cuda" in ln or "multi-block" in ln]
    require(res.returncode == 0 and n_ok == GATE_CHECKS and n_ng == 0,
            "the gradient gate failed:\n" + res.stdout + res.stderr)
    return lines


def phase_eval(device, keep):
    """eval's per-view function on the driver's final pool against the
    N_VIEWS ground-truth views at full width; view 0's PSNR must be finite
    and equal to the port's psnr of the same render."""
    pool, cams, gts, cfg = keep["pool"], keep["cams"], keep["gts"], keep["cfg"]
    *params, alive = (t.detach() for t in pool.activated())
    gaussians = [t[alive] for t in params]
    lines = [f"eval of the driver's final pool ({int(alive.sum())} gaussians) on {len(cams)} "
             f"views at {WIDTH}x{HEIGHT}:"]
    t0 = time.perf_counter()
    rows = evaluate_views(gaussians, cams, gts, sh_degree=cfg.sh_degree, device=device,
                          log_fn=lambda ln: lines.append("  " + ln))
    lines.append(f"  ({time.perf_counter() - t0:.2f} s) mean psnr "
                 f"{float(np.mean([r[0] for r in rows])):.4f}")
    img, _ = render(*gaussians, cams[0], sh_degree=cfg.sh_degree, max_patches=2**20,
                    need_grads=False, device=device)
    want = float(psnr(torch.clamp(img, 0, 1), torch.clamp(gts[0], 0, 1)))
    lines.append(f"  view 0 psnr by eval {rows[0][0]!r}, by psnr of the same render {want!r}")
    require(np.isfinite(rows[0][0]) and rows[0][0] == want, "eval's PSNR differs from psnr's")
    return lines


def colmap_scene(device):
    """Writes COLMAP_DIR from the bench scene (SH degree 3, DC from the
    scene): one PINHOLE camera of the views' intrinsics doubled, the
    N_VIEWS poses as quaternions, each view's photo the port's kernel
    render at 1958x1092 (0 patches or rows dropped) written by save_png,
    and the 65,536 positions jittered as SfM points with colours quantised
    from SH0. Returns (the scene's 979x546 cameras, the direct renders at
    that size, the points, lines)."""
    params, cams = scene_params(device, sh_random=False)
    args = [params[k] for k in ("pws", "shs", "alphas", "scales", "rots")]
    intr = {(float(c.fx), float(c.fy), float(c.cx), float(c.cy)) for c in cams}
    require(len(intr) == 1, f"the views do not share one camera: {intr}")
    fx, fy, cx, cy = (np.float64(v) for v in next(iter(intr)))
    cameras = {1: colmap.ColmapCamera(1, "PINHOLE", 2 * WIDTH, 2 * HEIGHT,
                                      2.0 * np.array([fx, fy, cx, cy]))}
    images, photos, direct, lines = {}, {}, [], []
    t0 = time.perf_counter()
    for i, cam in enumerate(cams):
        big = dataclasses.replace(cam, fx=2 * cam.fx, fy=2 * cam.fy, cx=2 * cam.cx,
                                  cy=2 * cam.cy, width=2 * WIDTH, height=2 * HEIGHT)
        img, aux = render(*args, big, sh_degree=3, max_patches=PHOTO_MAX_PATCHES,
                          max_rows=PHOTO_MAX_PATCHES, need_grads=False, device=device)
        bn = aux["binning"]
        require(int(bn["n_dropped"]) == 0 and int(bn["rows_dropped"]) == 0,
                f"photo {i} drops {int(bn['n_dropped'])} patches / {int(bn['rows_dropped'])} "
                f"rows at max_patches {PHOTO_MAX_PATCHES}")
        lines.append(f"photo {i}: {2 * WIDTH}x{2 * HEIGHT}, {int(bn['total'])} patches, "
                     f"{int(bn['total_rows'])} rows, 0 dropped")
        name = f"view{i}.png"
        photos[name] = to_uint8(img.cpu().numpy())
        images[i + 1] = colmap.ColmapImage(i + 1, rotmat2qvec(cam.Rcw),
                                           np.asarray(cam.tcw, np.float64), 1, name)
        direct.append(render(*args, cam, sh_degree=3, max_patches=MAX_PATCHES,
                             max_rows=MAX_ROWS, need_grads=False, device=device)[0])
    scene = make_synthetic_scene(seed=SEED, n_gaussians=N_GAUSSIANS, n_cams=N_VIEWS,
                                 width=WIDTH, height=HEIGHT, log_scale_mean=-3.6)
    rng = np.random.default_rng(SFM_SEED)
    xyz = scene["pws"] + rng.normal(scale=SFM_JITTER, size=scene["pws"].shape)
    rgb = np.clip((scene["shs"] * 0.28209479177387814 + 0.5) * 255, 0, 255).astype(np.uint8)
    if COLMAP_DIR.exists():
        shutil.rmtree(COLMAP_DIR)
    write_colmap_scene(COLMAP_DIR, cameras, images, xyz, rgb, photos)
    lines.append(f"wrote {COLMAP_DIR.relative_to(ROOT)} ({len(photos)} photos, "
                 f"{len(xyz)} points) in {time.perf_counter() - t0:.2f} s")
    return cams, direct, (xyz, rgb), lines


def _cam_close(got, want):
    for f in ("Rcw", "tcw", "fx", "fy", "cx", "cy"):
        a, b = np.asarray(getattr(got, f), np.float64), np.asarray(getattr(want, f), np.float64)
        if np.abs(a - b).max() > CAMERA_REL * np.abs(b).max():
            return False
    return (got.width, got.height) == (want.width, want.height)


def phase_colmap(device, smi):
    """The COLMAP path at full width: the scene of :func:`colmap_scene`
    loaded at COLMAP_RATE with the native and the Python readers, held to
    each other, to the scene's cameras, to the CPU path's decode and resize
    (bit-equal) and to the direct renders (PSNR_MIN); nvJPEG on every JPEG
    fixture within its limits of PIL's decode, with planted faults refused;
    the PNG fixtures and the CUDA resize bit-equal to PIL's; then the train
    CLI with --path in this process (its kernel launches counted from 0),
    and the eval and render CLIs with --path."""
    t0 = time.perf_counter()
    native_loader.build(force=True)
    native_loader.library()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    image_io.build_nvjpeg(force=True)
    image_io.nvjpeg_library()
    t_nvjpeg = time.perf_counter() - t0
    cams, direct, (xyz, rgb), lines = colmap_scene(device)
    lines.insert(0, f"host libraries built from source: native readers and PNG unfilter (g++) "
                    f"{t_native:.2f} s, nvJPEG decoder (nvcc -lnvjpeg) {t_nvjpeg:.2f} s")
    # an untimed load first: the first one pays for the CUDA ops' first use
    load_colmap_dataset(COLMAP_DIR, resize_rate=COLMAP_RATE, cache_points=False,
                        use_native=True, device=device)
    pngs_before = image_io.decode_png.calls
    loads = {}
    for native in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = load_colmap_dataset(COLMAP_DIR, resize_rate=COLMAP_RATE, cache_points=False,
                                 use_native=native, device=device)
        torch.cuda.synchronize()
        loads[native] = (ds, time.perf_counter() - t0)
    (nat, t_nat), (py, t_py) = loads[True], loads[False]
    require(image_io.decode_png.calls - pngs_before == 2 * N_VIEWS,
            "the port's PNG decoder did not decode every photo")
    require("PIL" not in sys.modules, "PIL was imported")
    require(len(nat) == N_VIEWS and len(py) == N_VIEWS, "a load lost views")
    for a, b in zip(nat.cameras, py.cameras):
        require(all(np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
                    for f in ("Rcw", "tcw", "fx", "fy", "cx", "cy", "width", "height", "id")),
                "the native and Python readers give different cameras")
    require(all(np.array_equal(nat.gs[k], py.gs[k]) for k in nat.gs.dtype.names)
            and nat.scene_size == py.scene_size,
            "the native and Python readers give different gaussians or scene_size")
    require(all(_cam_close(a, b) for a, b in zip(nat.cameras, cams)),
            f"the loaded cameras differ from the scene's by more than {CAMERA_REL} relative")
    psnrs = []
    for i, (a, b, want) in enumerate(zip(nat.images, py.images, direct)):
        cpu = load_image(nat.image_paths[i], COLMAP_RATE, device="cpu")
        require(a.shape == (3, HEIGHT, WIDTH) and torch.equal(a, b)
                and torch.equal(a.cpu(), cpu),
                f"photo {i} on the card differs from the CPU path's decode and resize")
        psnrs.append(float(psnr(a, torch.clamp(want, 0, 1))))
    lines.append(f"COLMAP load at {COLMAP_RATE} ({smi}): native readers {t_nat:.3f} s, Python "
                 f"readers {t_py:.3f} s for {N_VIEWS} photos and {len(xyz)} points; cameras, "
                 f"gaussians and scene_size ({nat.scene_size!r}) equal between the two, cameras "
                 f"within {CAMERA_REL} of the scene's, images bit-equal to the CPU path's")
    lines.append("photo PSNR against the direct 979x546 render (dB): "
                 + ", ".join(f"{v:.3f}" for v in psnrs) + f" (limit {PHOTO_PSNR_MIN})")
    require(min(psnrs) >= PHOTO_PSNR_MIN, f"a photo's PSNR is below {PHOTO_PSNR_MIN} dB")

    # the photo path's own times, each per image
    data = nat.image_paths[0].read_bytes()
    t0 = time.perf_counter()
    for _ in range(5):
        pixels, mode = image_io.decode_png(data)
    png_ms = (time.perf_counter() - t0) / 5 * 1e3
    full = torch.from_numpy(pixels).to(device)
    size = image_io.resized_size(full.shape[1], full.shape[0], COLMAP_RATE)
    image_io.pillow_resize(full, mode, size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        image_io.pillow_resize(full, mode, size)
    torch.cuda.synchronize()
    resize_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    points_to_gaussians(xyz, rgb)
    kd_s = time.perf_counter() - t0
    lines.append(f"photo path ({smi}): PNG decode {png_ms:.2f} ms per 1958x1092 photo (host: "
                 f"zlib and the C unfilter), resize to 979x546 on the card {resize_ms:.3f} ms "
                 f"per photo, cKDTree init of {len(xyz)} points {kd_s:.3f} s")

    ref = np.load(FIXTURES / "reference.npz")
    for name in sorted(JPEGS):
        data = (FIXTURES / name).read_bytes()
        got = image_io.decode_jpeg_cuda(data, device)
        t0 = time.perf_counter()
        for _ in range(10):
            image_io.decode_jpeg_cuda(data, device)
        ms = (time.perf_counter() - t0) / 10 * 1e3
        got, want = got.cpu().numpy().astype(np.int32), ref[f"decode/{name}"].astype(np.int32)
        worst, mean = int(np.abs(got - want).max()), float(np.abs(got - want).mean())
        faults = {}
        for fault, bad in planted_faults(got.astype(np.uint8)).items():
            d = np.abs(bad.astype(np.int32) - want)
            faults[fault] = (int(d.max()), float(d.mean()))
            require(d.max() > image_io.NVJPEG_MAX_ABS or d.mean() > image_io.NVJPEG_MEAN_ABS,
                    f"nvJPEG's limits accept the planted fault '{fault}' on {name}")
        lines.append(f"nvJPEG {name} {got.shape[1]}x{got.shape[0]} ({smi}): {ms:.3f} ms a "
                     f"decode, max |diff| to PIL {worst} levels, mean {mean:.4f} (limits "
                     f"{image_io.NVJPEG_MAX_ABS}, {image_io.NVJPEG_MEAN_ABS}); planted faults "
                     + ", ".join(f"{k} {v[0]}/{v[1]:.3f}" for k, v in faults.items()))
        require(worst <= image_io.NVJPEG_MAX_ABS and mean <= image_io.NVJPEG_MEAN_ABS,
                f"nvJPEG's decode of {name} is off PIL's by {worst} levels, mean {mean:.4f}")
        for rate in RATES:
            want = ref[f"resize{rate}/{name}"]
            dec = torch.from_numpy(ref[f"decode/{name}"]).to(device)
            out = image_io.pillow_resize(dec, "RGB", (want.shape[1], want.shape[0]))
            require(np.array_equal(out.cpu().numpy(), want),
                    f"the CUDA resize of {name} at {rate} is not PIL's")
    for name in sorted(PNGS):
        for rate in (1.0,) + RATES:
            want = ref[("decode/" if rate == 1.0 else f"resize{rate}/") + name]
            got = image_io.load_rgb8(FIXTURES / name, rate, device)
            require(np.array_equal(got.cpu().numpy(), want),
                    f"the PNG fixture {name} at {rate} on the card is not PIL's")
    lines.append(f"PNG fixtures {sorted(PNGS)} bit-equal to PIL at 1.0 and {RATES} on the card, "
                 f"and the CUDA resize of the JPEG fixtures' PIL decodes bit-equal to PIL's")

    out = ROOT / "build" / "smoke_colmap_train"
    for w in WRAPPERS.values():
        w.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        history = train_main(["--path", str(COLMAP_DIR), "--resize-rate", str(COLMAP_RATE),
                              "--epochs", "2", "--save-every", "2", "--out", str(out)])
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    losses = history["loss"]
    lines += [f"train CLI --path ({seconds:.1f} s, in this process): " + ln
              for ln in log.getvalue().strip().splitlines()[-4:]]
    lines.append(f"train CLI --path launches over {len(losses) * N_VIEWS} steps: {launches}")
    require(all(launches[k] > 0 for k in STEP_KERNELS),
            f"a kernel was not launched by the train CLI: {launches}")
    require(all(launches[k] == 0 for k in ROUTE_KERNELS),
            f"a sort-route kernel ran on the default route: {launches}")
    require(len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0],
            f"the train CLI's epoch losses are not finite and falling: {losses}")
    require(sum(history["overflow_steps"]) == 0,
            f"the train CLI dropped patches or rows: {history['overflow_steps']}")

    res, seconds = run_module("eval", "--path", str(COLMAP_DIR), "--resize-rate",
                              str(COLMAP_RATE), "--gs", str(out / "final.npy"))
    require(res.returncode == 0, f"eval CLI --path failed:\n{res.stdout}\n{res.stderr}")
    last = res.stdout.strip().splitlines()[-1]
    found = re.match(rf"mean over {N_VIEWS} views: psnr (\S+)", last)
    require(found is not None and np.isfinite(float(found.group(1))),
            f"eval CLI --path printed no finite mean PSNR: {last}")
    lines.append(f"eval CLI --path ({seconds:.1f} s): {last}")
    png = ROOT / "build" / "smoke_colmap_render.png"
    res, seconds = run_module("render", "--path", str(COLMAP_DIR), "--cam-index", "1",
                              "--resize-rate", str(COLMAP_RATE), "--backend", "cuda", "--gs",
                              str(out / "final.npy"), "--out", str(png))
    require(res.returncode == 0, f"render CLI --path failed:\n{res.stdout}\n{res.stderr}")
    shape = image_io.decode_png(png.read_bytes())[0].shape
    require(shape == (HEIGHT, WIDTH, 3), f"render CLI --path wrote a {shape} image")
    lines.append(f"render CLI --path ({seconds:.1f} s): {res.stdout.strip().splitlines()[-1]}")
    return lines


# The time-to-PSNR benchmark (bench_scene): the frozen full preset, run as
# its users run it (--epochs 60, whose length also sets the position
# learning-rate schedule), reaches PSNR 25 at epoch 9 on the card (NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md section 6); the gate requires it by 1.5x
# that epoch.
BENCH_EPOCH_CAP = 14
BENCH_SMOKE_EPOCHS = 6  # through the densify at epoch 5
GIF_FRAMES = 4


def bench_launches_expected(state, n_cams):
    """Each kernel's launches in one bench_scene run that trained: K2, K5
    and K6 once a step; K1 and K4 once a step and once a render (the ground
    truth, the eval views after each epoch, the training loop's own eval at
    its last epoch); K3 three times each of those."""
    hist = state["history"]
    return path_launches(len(hist["loss"]) * n_cams,
                         n_cams + 4 * len(state["curve"]) + len(hist["psnr"]))


def path_launches(steps, renders):
    """K1-K6's launches on a path of ``steps`` cameras trained and
    ``renders`` forward renders (a banded step counts as a step, a band of
    a render as a render): K2, K5 and K6 once a trained camera; K1 and K4
    once each; K3 three times each."""
    one = steps + renders
    return {"K1 preprocess_fwd": one, "K2 preprocess_bwd": steps, "K3 multi_cumsum": 3 * one,
            "K4 rasterize_fwd": one, "K5 rasterize_bwd": steps, "K6 segmented_cumsum": steps}


def run_bench_scene(*argv):
    """bench_scene's main in this process on ``argv``, its stdout kept:
    (its JSON lines as printed and parsed, the training state, the printed
    lines, the launches, seconds, peak device memory in bytes)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        lines, state = bench_scene.main(list(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    printed = log.getvalue().strip().splitlines()
    parsed = [json.loads(ln) for ln in printed if ln.startswith("{")]
    require(parsed == json.loads(json.dumps(lines)),
            f"bench_scene {argv}: its JSON lines do not parse back to what it returned")
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    return (parsed, state, printed, launches, seconds,
            torch.cuda.max_memory_allocated())


def check_bench_launches(label, state, launches, n_cams):
    want = bench_launches_expected(state, n_cams)
    got = {k: launches[k] for k in want}
    require(got == want, f"{label}: launches {got}, the steps and renders need {want}")
    require(all(launches[k] == 0 for k in ROUTE_KERNELS + K9_KERNELS + ("K10 stream_sums",)),
            f"{label}: a kernel off the default path ran: {launches}")
    return f"{label} launches {got}, as many as its steps and renders need"


def phase_bench_scene(smi):
    """bench_scene on the card: --smoke (in this process, its launches
    counted from 0 and held to its steps and renders); the full preset,
    which must reach PSNR 25 by epoch BENCH_EPOCH_CAP; --oracle-gt of both
    presets; --realism for 2 epochs at full size."""
    t_phase = time.perf_counter()
    lines = []
    full_cams = bench_scene.FULL[1]
    parsed, state, printed, launches, seconds, _ = run_bench_scene(
        "--smoke", "--epochs", str(BENCH_SMOKE_EPOCHS))
    lines.append(f"bench_scene --smoke --epochs {BENCH_SMOKE_EPOCHS} ({seconds:.1f} s): "
                 + printed[-1])
    lines.append(check_bench_launches("bench_scene --smoke", state, launches, bench_scene.SMOKE[1]))
    require([r["epoch"] for r in state["curve"]] == list(range(1, BENCH_SMOKE_EPOCHS + 1))
            and set(parsed[0]) == {"attribution", "curve"}
            and parsed[1]["metric"] == "time_to_psnr25",
            f"bench_scene --smoke printed {parsed}")

    parsed, state, printed, launches, seconds, peak = run_bench_scene()
    gt_line = next(ln for ln in printed if ln.startswith("rendered "))
    lines.append(f"bench_scene full preset ({smi}; {seconds:.1f} s in all): {gt_line}; "
                 + next(ln for ln in printed if ln.startswith("init ")))
    lines.append(f"  peak device memory (torch.cuda.max_memory_allocated): {peak} B")
    for r in state["curve"]:
        lines.append(f"  curve: {json.dumps(r)}")
    lines.append(f"  overflow_steps per epoch: {[r['overflow_steps'] for r in state['curve']]}")
    lines.append(f"  {json.dumps(parsed[0]['attribution'])}")
    lines.append(f"  {json.dumps(parsed[1])}")
    lines.append("  " + check_bench_launches("bench_scene full", state, launches, full_cams))
    hit = state["epoch_hit"]
    require(hit is not None and hit <= BENCH_EPOCH_CAP and parsed[1]["metric"] == "time_to_psnr25",
            f"the full preset did not reach PSNR 25 by epoch {BENCH_EPOCH_CAP} "
            f"(final {state['psnr']:.3f})")
    lines.append(f"  PSNR 25 reached at epoch {hit} (cap {BENCH_EPOCH_CAP}), time_to_psnr25 "
                 f"{parsed[1]['value']} s")

    for argv in (("--oracle-gt",), ("--realism", "--oracle-gt")):
        parsed, _, printed, launches, seconds, peak = run_bench_scene(*argv)
        warn = [ln for ln in printed if ln.startswith("WARNING")]
        lines.append(f"bench_scene {' '.join(argv)} ({seconds:.1f} s, peak {peak} B): "
                     f"{json.dumps(parsed[0])}" + (f"; {warn[0]}" if warn else ""))
        require(parsed[0]["metric"].startswith("oracle_gt_psnr")
                and np.isfinite(parsed[0]["value"]), f"no oracle PSNR: {parsed}")
        n_renders = full_cams + 4
        require(launches["K1 preprocess_fwd"] == n_renders and launches["K2 preprocess_bwd"] == 0,
                f"bench_scene {argv}: launches {launches}, {n_renders} renders need K1 "
                f"{n_renders} and no K2")
    parsed, state, printed, launches, seconds, peak = run_bench_scene("--realism", "--epochs", "2")
    lines.append(f"bench_scene --realism --epochs 2 ({seconds:.1f} s, peak {peak} B): "
                 + next(ln for ln in printed if ln.startswith("rendered ")) + "; "
                 + json.dumps(parsed[1]))
    lines.append("  " + check_bench_launches("bench_scene --realism", state, launches,
                                             full_cams))
    require(len(state["curve"]) == 2 and all(np.isfinite(r["psnr"]) for r in state["curve"]),
            f"bench_scene --realism: {state['curve']}")
    lines.append(f"bench_scene phase: {time.perf_counter() - t_phase:.1f} s")
    return lines


def frame_check(label, got, want):
    """A viewer frame against the all-plain path's: within 1 level, at most
    SLICE_MAX_BAD_SHARE of its pixels a level off."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    off = float((d > 0).any(-1).mean())
    require(got.shape == want.shape and d.max() <= 1 and off <= SLICE_MAX_BAD_SHARE,
            f"viewer frame {label}: max {d.max()} levels off the all-plain path on "
            f"{off:.5f} of its pixels")
    return f"max {d.max()} level, {off:.6f} of pixels off"


def gif_blocks(data):
    """(width, height, frame count, NETSCAPE loop count, delays in 1/100 s)
    of a GIF89a, read with struct."""
    require(data[:6] == b"GIF89a", f"not a GIF89a: {data[:6]!r}")
    width, height, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, loop, delays = [], None, []

    def sub_blocks(pos):
        out = []
        while data[pos]:
            out.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return out, pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            blocks, pos = sub_blocks(pos + 2)
            if label == 0xFF and blocks[0] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", blocks[1][1:3])[0]
            elif label == 0xF9:
                delays.append(struct.unpack("<H", blocks[0][1:3])[0])
        elif data[pos] == 0x2C:
            fw, fh, fpacked = struct.unpack("<4xHHB", data[pos + 1:pos + 10])
            frames.append((fw, fh))
            pos += 10 + (3 << ((fpacked & 7) + 1) if fpacked & 0x80 else 0)
            _, pos = sub_blocks(pos + 1)  # the LZW code size byte, then the data
        else:
            require(False, f"GIF block 0x{data[pos]:02x} at byte {pos}")
    return width, height, frames, loop, delays


def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def viewer_scene(device):
    """viewer_fps's scene (65,536 gaussians, SH padded to degree 3) with the
    bench views as dataset cameras (random photos on their image planes)
    and every 16th gaussian as a point cloud."""
    g = viewer_fps.scene_gaussians(N_GAUSSIANS, WIDTH, HEIGHT)
    cams = make_synthetic_scene(seed=SEED, n_gaussians=N_GAUSSIANS, n_cams=N_VIEWS, width=WIDTH,
                                height=HEIGHT, log_scale_mean=-3.6)["cameras"]
    rng = np.random.default_rng(SEED + 3)
    photos = [rng.random((3, HEIGHT // 8, WIDTH // 8)).astype(np.float32) for _ in cams]
    spread = float(np.percentile(np.linalg.norm(g["pws"] - g["pws"].mean(0), axis=1), 90))
    cloud = {"pws": g["pws"][::16], "rots": g["rots"][::16],
             "scales": np.full((len(g["pws"][::16]), 3), 0.002 * spread, np.float32),
             "alphas": np.full(len(g["pws"][::16]), 0.9, np.float32),
             "shs": g["shs"][::16, :3]}
    kw = dict(dataset_cameras=cams, dataset_images=photos, cloud=cloud, marker_skip=1,
              max_patches=viewer_fps.FULL[3], device=device)
    return SceneRenderer(g, backend="cuda", **kw), SceneRenderer(g, backend="tiled", **kw), g


def phase_viewer(device, smi):
    """The viewer on the card: SceneRenderer frames of every mode and
    toggle against the all-plain path, each launching K1 once, K3's 3 calls
    and K4 once; the HTTP server (PNG bodies bit-equal to the frames, 400,
    404); viewer_fps; a GIF turntable read back with struct; and the
    training monitor over 2 epochs of train."""
    t_phase = time.perf_counter()
    lines = []
    kern, plain, g = viewer_scene(device)
    view = dict(azimuth=0.6, elevation=0.35, width=WIDTH, height=HEIGHT)
    frames = [(f"mode={m} markers={mk}", dict(mode=m, markers=mk))
              for m in MODES for mk in (False, True)]
    frames += [(f"cloud_mode={cm}", dict(cloud=True, cloud_mode=cm)) for cm in CLOUD_MODES]
    frames += [("axes and grid", dict(axes=True, grid=True)), ("lores", dict(lores=True))]
    per_frame = {"K1 preprocess_fwd": 1, "K3 multi_cumsum": 3, "K4 rasterize_fwd": 1}
    shots = {}
    for label, kw in frames:
        reset_launches()
        got = kern.render(**view, **kw)
        launches = {k: w.launches for k, w in WRAPPERS.items()}
        require(launches == {k: per_frame.get(k, 0) for k in WRAPPERS},
                f"viewer frame {label} launched {launches}")
        want = plain.render(**view, **kw)
        shots[label] = got
        lines.append(f"viewer frame {label} {got.shape[1]}x{got.shape[0]}: "
                     f"{frame_check(label, got, want)}; launches K1 1, K3 3, K4 1")
    base = shots["mode=normal markers=False"]
    require(not any(np.array_equal(base, shots[k])
                    for k in ("mode=normal markers=True", "cloud_mode=rgb", "axes and grid")),
            "an overlay toggle did not change the frame")

    started = []
    thread = threading.Thread(target=serve, args=(kern,),
                              kwargs=dict(port=0, on_ready=started.append), daemon=True)
    with contextlib.redirect_stdout(io.StringIO()):
        thread.start()
        for _ in range(600):
            if started:
                break
            time.sleep(0.05)
    require(bool(started), "the viewer server did not start")
    url = f"http://127.0.0.1:{started[0].server_address[1]}"
    try:
        for query, kw in ((f"az=0.6&el=0.35&w={WIDTH}&h={HEIGHT}", dict(view)),
                          (f"az=0.6&el=0.35&w={WIDTH}&h={HEIGHT}&lores=1&fmt=jpeg",
                           dict(view, lores=True)),
                          (f"az=1.2&el=0.2&w={WIDTH}&h={HEIGHT}&mode=inverse&markers=1&axes=1",
                           dict(azimuth=1.2, elevation=0.2, width=WIDTH, height=HEIGHT,
                                mode="inverse", markers=True, axes=True))):
            t0 = time.perf_counter()
            status, ctype, body = http_get(f"{url}/render?{query}")
            ms = (time.perf_counter() - t0) * 1e3
            require(status == 200 and ctype == "image/png", f"/render?{query}: {status} {ctype}")
            pixels, mode = image_io.decode_png(body)
            want = kern.render(**kw)
            require(mode == "RGB" and np.array_equal(pixels, want),
                    f"/render?{query}: the PNG body is not the frame render() gives")
            lines.append(f"HTTP /render?{query}: 200 image/png, {len(body)} B in {ms:.1f} ms, "
                         f"decoded {pixels.shape[1]}x{pixels.shape[0]} bit-equal to render()")
        for path, code in (("/render?mode=wire", 400), ("/nope", 404)):
            status, _, _ = http_get(url + path)
            require(status == code, f"{path}: {status}, not {code}")
        status, _, body = http_get(url + "/info")
        require(status == 200 and json.loads(body)["n_gaussians"] == N_GAUSSIANS, "/info")
        lines.append("HTTP /render?mode=wire: 400, /nope: 404, /info: 200")
    finally:
        started[0].shutdown()
        thread.join(timeout=60)
    require(not thread.is_alive(), "the viewer server did not stop")

    del kern, plain
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fps = viewer_fps.main([])
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    lines += [f"viewer_fps ({smi}): {ln}" for ln in out.getvalue().strip().splitlines()]
    lines.append(f"viewer_fps peak device memory: {torch.cuda.max_memory_allocated() - held} B "
                 f"above the {held} B held before it (torch.cuda.max_memory_allocated)")
    n_frames = 2 * (1 + 3 * 10)
    require(launches["K1 preprocess_fwd"] == n_frames and launches["K4 rasterize_fwd"] == n_frames
            and launches["K3 multi_cumsum"] == 3 * n_frames,
            f"viewer_fps: launches {launches} for {n_frames} frames")
    require(all(np.isfinite(v[2]) and v[2] > 0 for v in fps.values()), f"viewer_fps: {fps}")

    gif_path = ROOT / "build" / "smoke_turntable.gif"
    reset_launches()
    t0 = time.perf_counter()
    turn = render_turntable(g, n_frames=GIF_FRAMES, width=640, height=480, device=device,
                            max_patches=viewer_fps.FULL[3])
    save_gif(gif_path, turn, fps=20)
    seconds = time.perf_counter() - t0
    require(preprocess.preprocess_fwd.launches == GIF_FRAMES
            and rasterize.rasterize_fwd.launches == GIF_FRAMES,
            f"turntable launches K1 {preprocess.preprocess_fwd.launches}, K4 "
            f"{rasterize.rasterize_fwd.launches} for {GIF_FRAMES} frames")
    data = gif_path.read_bytes()
    width, height, gframes, loop, delays = gif_blocks(data)
    require((width, height) == (640, 480) and gframes == [(640, 480)] * GIF_FRAMES
            and loop == 0 and delays == [5] * GIF_FRAMES,
            f"the turntable GIF reads {width}x{height}, frames {gframes}, loop {loop}, "
            f"delays {delays}")
    lines.append(f"turntable: {GIF_FRAMES} frames 640x480 rendered and written in {seconds:.2f} s, "
                 f"GIF89a {len(data)} B, {GIF_FRAMES} image blocks, NETSCAPE loop 0, delay 50 ms")

    pool, cams, gts, scene_size, cfg = train_setup(device)
    cfg = dataclasses.replace(cfg, epochs=2)
    mon = TrainingMonitor(cams[0], cfg, port=0, log_fn=lambda *_: None)
    try:
        t0 = time.perf_counter()
        train(pool, cams, gts, cfg, scene_size, seed=SEED, log_fn=lambda *_: None,
              eval_every=1, epoch_cb=mon.epoch_cb)
        seconds = time.perf_counter() - t0
        murl = f"http://127.0.0.1:{mon.port}"
        status, _, body = http_get(murl + "/history")
        hist = json.loads(body)
        require(status == 200 and hist["epoch"] == 2 and len(hist["loss"]) == 2,
                f"monitor /history: {status} {hist}")
        status, ctype, body = http_get(murl + "/preview.png")
        pixels, _ = image_io.decode_png(body)
        require(status == 200 and ctype == "image/png" and pixels.shape == (HEIGHT, WIDTH, 3),
                f"monitor /preview.png: {status} {ctype} {pixels.shape}")
        lines.append(f"monitor: train 2 epochs x {N_VIEWS} views in {seconds:.2f} s; /history "
                     f"epoch {hist['epoch']}, loss {[round(v, 6) for v in hist['loss']]}, psnr "
                     f"{[round(p, 3) for _, p in hist['psnr']]}; /preview.png {len(body)} B "
                     f"decodes to {pixels.shape[1]}x{pixels.shape[0]}")
    finally:
        mon.close()
    lines.append(f"viewer phase: {time.perf_counter() - t_phase:.1f} s")
    return lines


# The multi-device phase (parallel/) at bench.py's width: (a) world size 1
# under NCCL in this process; (b) MD_RANKS ranks on the one card, child
# processes joined by gloo (NCCL takes one rank a card), each under
# MD_RANK_TIMEOUT seconds; (c) the entry points.
MD_DIR = ROOT / "build" / "smoke_md"
MD_RANKS = 2
MD_BATCH = 2
MD_RANK_TIMEOUT = 300
MD_TIMED = 20


def launches_now():
    return {k: w.launches for k, w in WRAPPERS.items()}


def check_launches(label, launches, steps, renders):
    """``launches`` against what ``steps`` trained cameras and ``renders``
    renders need; no other kernel may have run."""
    want = path_launches(steps, renders)
    got = {k: launches[k] for k in want}
    require(got == want, f"{label}: launches {got}, its steps and renders need {want}")
    others = {k: v for k, v in launches.items() if k not in want and v}
    require(not others, f"{label}: a kernel off the default path ran: {others}")
    return f"{label}: launches {got}, as many as its steps and renders need"


def counted(fn):
    """(fn(), the launches it made, counted from 0, after a synchronise)."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, launches_now()


def render_check(label, img, want, dropped):
    """A multi-device render against the single-device one: the render
    gate (at most SLICE_MAX_BAD_SHARE of the pixels over SLICE_TOL), 0
    drops."""
    bad = int(((img - want).abs() > SLICE_TOL).any(dim=0).sum())
    n_pix = want.shape[1] * want.shape[2]
    line = (f"{label}: max_abs_err {float((img - want).abs().max()):.3e}, bit-equal "
            f"{torch.equal(img, want)}, pixels over {SLICE_TOL}: {bad} of {n_pix}, dropped "
            f"{int(dropped)}")
    require(img.shape == want.shape and bad <= SLICE_MAX_BAD_SHARE * n_pix and int(dropped) == 0,
            line)
    return line


def step_check(label, loss, grads, dropped, want_loss, want_grads):
    """A multi-device step's loss and gradients against the single-device
    ones, within phase_step_compare's limits; 0 drops."""
    rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    same = float(loss) == float(want_loss) and all(torch.equal(grads[k], want_grads[k])
                                                    for k in want_grads)
    lines = [f"{label}: loss {float(loss):.7f} vs {float(want_loss):.7f} (rel {rel:.2e}), "
             f"bit-equal {same}, dropped {int(dropped)}"]
    require(rel <= STEP_LOSS_RTOL and int(dropped) == 0, lines[0])
    lines += group_check(f"  {label} gradients", list(want_grads),
                         [grads[k] for k in want_grads], [want_grads[k] for k in want_grads],
                         STEP_REL)[1]
    return lines


def md_world_one(device, pool, cams, gts, scene_size, cfg):
    """(a): world size 1 under NCCL in this process. Returns (lines, the
    single-device references of (b))."""
    lines = []
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        lines.append(f"world size 1 under {dist.get_backend()}: mesh {mesh.shape}")
        states = []
        for _ in range(2):
            p = copy.deepcopy(pool)
            states.append([p, adam_init(p.params()), density_stats_init(p.capacity, device)])
        (p1, a1, s1), (p2, a2, s2) = states
        single = make_train_step(cfg, scene_size, 10, device=device)
        loss1, b1 = single(p1, a1, s1, cams[0], gts[0])
        p2, a2, s2 = shard_pool(mesh, p2, a2, s2)
        step = make_sharded_train_step(mesh, cfg, scene_size, 10)
        (loss2, b2), launches = counted(lambda: step(p2, a2, s2, stack_cameras(cams[:1]),
                                                     gts[:1]))
        lines.append(check_launches("  sharded step at batch 1", launches, 1, 0))
        same = (torch.equal(loss1, loss2)
                and all(torch.equal(v, getattr(p2, k)) for k, v in p1.params().items())
                and all(torch.equal(a1.mu[k], a2.mu[k]) and torch.equal(a1.nu[k], a2.nu[k])
                        for k in GROUPS)
                and torch.equal(s1.grad_accum, s2.grad_accum) and torch.equal(s1.cunt, s2.cunt))
        lines.append(f"  sharded step at batch 1 vs make_train_step on view 0: loss "
                     f"{float(loss2):.7f} vs {float(loss1):.7f}; parameters, Adam moments and "
                     f"density stats bit-equal: {same}; dropped {int(b2['dropped'])}")
        require(same and int(b2["dropped"]) == 0 == int(b1["dropped"]),
                "the sharded step at batch 1 differs from make_train_step")
        # what one rank costs: the steps above, on, from the state they left
        ms_single = render_wall(lambda: single(p1, a1, s1, cams[0], gts[0]), MD_TIMED)[0]
        ms_one = render_wall(lambda: step(p2, a2, s2, stack_cameras(cams[:1]), gts[:1]),
                             MD_TIMED)[0]
        ms_all = render_wall(lambda: step(p2, a2, s2, stack_cameras(cams), gts), MD_TIMED)[0]
        lines.append(f"  one rank's cost, median of {MD_TIMED} steps after 2 warm (host clock "
                     f"to a synchronise): make_train_step {ms_single:.3f} ms; the sharded step "
                     f"(NCCL, world size 1) at batch 1 {ms_one:.3f} ms, at batch {N_VIEWS} "
                     f"{ms_all:.3f} ms ({ms_all / N_VIEWS:.3f} ms a camera)")
        del states, p1, a1, s1, p2, a2, s2

        out, launches = counted(lambda: sharded_loss_and_grads(
            mesh, pool, stack_cameras(cams), gts, cfg))
        loss4, g4, vis4, drop4 = out
        lines.append(check_launches(f"  sharded loss and gradients at batch {N_VIEWS}",
                                    launches, N_VIEWS, 0))
        singles = [loss_and_grads(pool, cam, gt, cfg) for cam, gt in zip(cams, gts)]
        want_loss = torch.stack([s[0] for s in singles]).mean()
        want = {k: sum(s[1][k] for s in singles) / N_VIEWS for k in g4}
        vis_want = functools.reduce(torch.logical_or,
                                    [s[2]["depths"] >= stages.MIN_DEPTH for s in singles])
        rel = abs(float(loss4) - float(want_loss)) / float(want_loss)
        lines.append(f"  batch {N_VIEWS} vs the mean of {N_VIEWS} single-camera steps: loss "
                     f"{float(loss4):.7f} vs {float(want_loss):.7f} (rel {rel:.2e}), "
                     f"visibility equal {torch.equal(vis4, vis_want)}, dropped {int(drop4)}")
        require(rel <= STEP_LOSS_RTOL and torch.equal(vis4, vis_want) and int(drop4) == 0,
                "the batched loss or visibility differs from the single-camera steps'")
        lines += group_check(f"  batch {N_VIEWS} gradients", list(want), [g4[k] for k in want],
                             [want[k] for k in want], KERNEL_REL)[1]
        del singles, g4, want

        (img, aux), launches = counted(lambda: make_sharded_render(mesh, cfg, with_aux=True)(
            pool, cams[0]))
        lines.append(check_launches("  replicated render", launches, 0, 1))
        want_img, _ = render_pool_image(pool, cams[0], cfg, need_grads=False)
        lines.append(render_check("  replicated render vs render", img, want_img,
                                  aux["n_dropped"]))

        logs = []
        t0 = time.perf_counter()
        (p3, hist), launches = counted(lambda: train_sharded(
            copy.deepcopy(pool), cams, gts, dataclasses.replace(cfg, epochs=2), scene_size,
            mesh, batch=MD_BATCH, log_fn=logs.append))
        seconds = time.perf_counter() - t0
        lines.append(check_launches(f"  train_sharded, 2 epochs of {N_VIEWS} views at batch "
                                    f"{MD_BATCH}", launches, 2 * N_VIEWS, len(hist["psnr"])))
        lines.append(f"  train_sharded ({seconds:.1f} s): losses {hist['loss']}, psnr "
                     f"{hist['psnr']}, alive {hist['n_alive']}, overflow steps "
                     f"{hist['overflow_steps']}; " + " | ".join(logs))
        require(np.isfinite(hist["loss"]).all() and hist["overflow_steps"] == [0, 0]
                and int(p3.n_alive()) == int(pool.n_alive()), "train_sharded went wrong")
        refs = {"banded": loss_and_grads(pool, cams[0], gts[0], cfg)[:2],
                "batched": sharded_loss_and_grads(mesh, pool, stack_cameras(cams[:MD_BATCH]),
                                                  gts[:MD_BATCH], cfg)[:2],
                "render": want_img}
    finally:
        dist.destroy_process_group()
    return lines, refs


def md_rank(rank, port, inp, out):
    """One rank of (b): ``MD_RANKS`` ranks on cuda:0 joined by gloo, each
    computing the banded step and render over its band and the batched
    step on (data 2, gs 1) and (data 1, gs 2) from the state the parent
    wrote; rank 0 writes the results, every rank prints its launches."""
    require(not _build.needs_build(), "a rank would build the kernels the parent built")
    dev = init_distributed(f"localhost:{port}", MD_RANKS, rank, device="cuda:0",
                           backend="gloo", timeout_s=MD_RANK_TIMEOUT)
    state = torch.load(inp)
    pool = GaussianPool(*(state[k].to(dev) for k in GROUPS), alive=state["alive"].to(dev))
    gts = [g.to(dev) for g in state["gts"]]
    cams = make_synthetic_scene(seed=SEED, n_gaussians=N_GAUSSIANS, n_cams=N_VIEWS, width=WIDTH,
                                height=HEIGHT, log_scale_mean=-3.6)["cameras"]
    cfg = TrainConfig(max_patches=MAX_PATCHES, max_rows=MAX_ROWS, sh_degree=3)
    res, launches = {}, {}
    mesh = make_mesh(MD_RANKS)  # (1, MD_RANKS): MD_RANKS bands
    shard = shard_pool(mesh, pool)
    out_b, launches["banded step"] = counted(lambda: banded_loss_and_grads(
        mesh, shard, cams[0], gts[0], cfg))
    res["banded"] = (out_b[0], fetch_to_host(mesh, out_b[1]), out_b[3])
    (img, aux), launches["banded render"] = counted(lambda: make_sharded_render(
        mesh, cfg, with_aux=True)(shard, cams[0]))
    res["render"] = (img, aux["n_dropped"])
    for data in (MD_RANKS, 1):
        mesh = make_mesh(MD_RANKS, data=data)
        shard = shard_pool(mesh, pool)
        label = f"batched {tuple(mesh.shape.values())}"
        out_s, launches[label] = counted(lambda: sharded_loss_and_grads(
            mesh, shard, shard_batch(mesh, stack_cameras(cams[:MD_BATCH])),
            shard_batch(mesh, gts[:MD_BATCH]), cfg))
        res[label] = (out_s[0], fetch_to_host(mesh, out_s[1]), out_s[3])
    if rank == 0:
        torch.save({k: tuple(v.cpu() if torch.is_tensor(v) else {g: t.cpu() for g, t in v.items()}
                             for v in vals) for k, vals in res.items()}, out)
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "launches": launches}), flush=True)


def md_entry_points(device):
    """(c): dryrun_multichip(1) and bench_scaling at world size 1 (each
    starts its rank as a child process) beside the train CLI with --batch
    2 --mesh-data 1 and entry() in this process."""
    lines, results = [], {}

    def dryrun():
        t0 = time.perf_counter()
        results["dryrun"] = (graft_entry.dryrun_multichip(1), time.perf_counter() - t0)

    thread = threading.Thread(target=lambda: _guarded(results, "dryrun", dryrun))
    bench = subprocess.Popen([sys.executable, "-m", "easygaussiansplatting_tpu_torch.bench_scaling",
                              "--trials", "3"], cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    t_bench = time.perf_counter()
    thread.start()
    try:
        out = MD_DIR / "cli"
        if (out / "final.npy").exists():
            (out / "final.npy").unlink()
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            hist, launches = counted(lambda: train_main([
                "--synthetic", "--epochs", "2", "--batch", "2", "--mesh-data", "1",
                "--out", str(out)]))
        printed = log.getvalue().strip().splitlines()
        lines.append(f"train CLI --synthetic --batch 2 --mesh-data 1 ({time.perf_counter() - t0:.1f}"
                     f" s): " + " | ".join(printed[-3:]))
        lines.append(check_launches("  train CLI", launches, 2 * 8, 8 + len(hist["psnr"])))
        require((out / "final.npy").exists() and any("mesh {'data': 1, 'gs': 1}; batch=2" in ln
                                                      for ln in printed)
                and hist["overflow_steps"] == [0, 0], "the train CLI's sharded run went wrong")

        fn, args = graft_entry.entry()
        img, launches = counted(lambda: fn(*args))
        lines.append(check_launches("  entry()", launches, 0, 1))
        want, _ = render(*args[:5], Camera.from_dict({
            "Rcw": args[5].cpu(), "tcw": args[6].cpu(), "fx": args[7].cpu(), "fy": args[8].cpu(),
            "cx": args[9].cpu(), "cy": args[10].cpu(), "width": 256, "height": 192}),
            backend="tiled", max_patches=2**16, need_grads=False, device=device)
        lines.append(render_check("entry() [3, 192, 256] vs the all-plain path", img.detach(),
                                  want, 0))
    finally:
        thread.join()
        try:
            stdout, stderr = bench.communicate(timeout=MD_RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            bench.kill()
            stdout, stderr = bench.communicate()
    if isinstance(results.get("dryrun"), BaseException):
        raise results["dryrun"]
    reports, seconds = results["dryrun"]
    lines.append(f"dryrun_multichip(1) ({seconds:.1f} s): {json.dumps(reports)}")
    require(len(reports) == 1 and reports[0]["mesh"] == [1, 1], "dryrun_multichip(1) went wrong")
    require(bench.returncode == 0, f"bench_scaling failed:\n{stdout}\n{stderr}")
    printed = stdout.strip().splitlines()
    rec = json.loads(printed[-1])
    lines += [f"bench_scaling ({time.perf_counter() - t_bench:.1f} s): {ln}" for ln in printed]
    require(rec["metric"] == "scaling_efficiency" and rec["value"] is None
            and "no scaling" in rec["note"], f"bench_scaling's line: {rec}")
    return lines


def _guarded(results, name, fn):
    try:
        fn()
    except BaseException as e:  # raised again in the phase's thread
        results[name] = e


def phase_multidevice(device, smi):
    """The multi-device phase: (a), (b) and (c) above, with the seconds of
    each. (b)'s ranks start first and load while (a) runs."""
    t_phase = time.perf_counter()
    lines = [f"multi-device phase on {smi}"]
    pool, cams, gts, scene_size, cfg = train_setup(device)
    MD_DIR.mkdir(parents=True, exist_ok=True)
    inp, out = MD_DIR / "state.pt", MD_DIR / "ranks.pt"
    if out.exists():
        out.unlink()
    torch.save({**{k: getattr(pool, k).detach().cpu() for k in GROUPS},
                "alive": pool.alive.cpu(), "gts": [g.cpu() for g in gts]}, inp)
    port, results = free_port(), {}

    def ranks():
        t0 = time.perf_counter()
        results["ranks"] = (launch_ranks(
            lambda r: [sys.executable, str(ROOT / "chip_smoke.py"), "--md-rank", str(r),
                       str(port), str(inp), str(out)], MD_RANKS, MD_RANK_TIMEOUT, cwd=ROOT),
            time.perf_counter() - t0)

    thread = threading.Thread(target=lambda: _guarded(results, "ranks", ranks))
    thread.start()
    try:
        t0 = time.perf_counter()
        a_lines, refs = md_world_one(device, pool, cams, gts, scene_size, cfg)
        lines += a_lines
        lines.append(f"(a) world size 1: {time.perf_counter() - t0:.1f} s")
    finally:
        thread.join()
    if isinstance(results.get("ranks"), BaseException):
        raise results["ranks"]
    outs, seconds = results["ranks"]
    lines.append(f"(b) {MD_RANKS} ranks on cuda:0 joined by gloo: {seconds:.1f} s (with their "
                 f"start-up, beside (a))")
    res = torch.load(out)
    for text in outs:
        rep = json.loads(text.strip().splitlines()[-1])
        per = {"banded step": (1, 0), "banded render": (0, 1),
               f"batched ({MD_RANKS}, 1)": (MD_BATCH // MD_RANKS, 0),
               f"batched (1, {MD_RANKS})": (MD_BATCH, 0)}
        for label, (steps, renders) in per.items():
            lines.append(check_launches(f"  rank {rep['rank']} {label}", rep["launches"][label],
                                        steps, renders))
    loss, grads, dropped = res["banded"]
    want_loss, want_grads = refs["banded"]
    lines += step_check(f"  banded step over {MD_RANKS} bands vs make_train_step's",
                        loss, {k: v.to(device) for k, v in grads.items()}, dropped, want_loss,
                        want_grads)
    img, dropped = res["render"]
    lines.append(render_check(f"  banded render over {MD_RANKS} bands vs render", img.to(device),
                              refs["render"], dropped))
    want_loss, want_grads = refs["batched"]
    for shape in ((MD_RANKS, 1), (1, MD_RANKS)):
        loss, grads, dropped = res[f"batched {shape}"]
        lines += step_check(f"  batched step on {shape} at batch {MD_BATCH} vs world size 1",
                            loss, {k: v.to(device) for k, v in grads.items()}, dropped,
                            want_loss, want_grads)
    t0 = time.perf_counter()
    lines += md_entry_points(device)
    lines.append(f"(c) entry points: {time.perf_counter() - t0:.1f} s")
    lines.append(f"multi-device phase: {time.perf_counter() - t_phase:.1f} s")
    return lines


def print_timing(entry):
    lib = "none" if entry["library_ms"] is None else f"{entry['library_ms']:.4f} ms"
    print(f"{entry['name']}: {entry['ms']:.4f} ms by CUDA events ({entry['call_ms']:.4f} ms "
          f"per call with the host's launch work), plain {entry['plain_ms']:.4f} ms, library "
          f"{lib}, bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}", flush=True)


def main():
    if sys.argv[1:2] == ["--md-rank"]:  # a rank of the multi-device phase
        return md_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain K4 version's matmul
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"max SM clock {clock_mhz} MHz, {n_sm} SMs", flush=True)

    t0 = time.perf_counter()
    _, build_s, log = _build.build(force=True)
    _build.library()
    print(f"build: {build_s:.1f} s (nvcc, one process per source, in parallel)", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    sass_dump()

    launches, lines, (render_once, wall_ms) = phase_slice(device)
    for line in lines:
        print(line, flush=True)

    flush = make_flush(device)
    kernels = []
    for phase in (phase_k1, phase_k3, phase_k4):
        entry, lines = phase(device, flush, clock_mhz, n_sm)
        entry["launches"] = launches[entry["name"]]
        for line in lines:
            print(line, flush=True)
        print_timing(entry)
        kernels.append(entry)

    for line in phase_profile("render", render_once, wall_ms, RENDER_GROUPS)[1]:
        print(line, flush=True)

    train_launches, lines, (pool, cams, gts, cfg) = phase_train(device)
    for line in lines:
        print(line, flush=True)
    for line in phase_step_compare(pool, cams[0], gts[0], cfg):
        print(line, flush=True)
    seen = step_inputs(pool, cams[0], gts[0], cfg)
    for phase in (phase_k2, phase_k5, phase_k6):
        entry, lines = phase(seen, flush, clock_mhz, n_sm)
        entry["launches"] = train_launches[entry["name"]]
        for line in lines:
            print(line, flush=True)
        print_timing(entry)
        kernels.append(entry)

    route_launches, calls, lines = phase_routes(pool, cams[0], gts[0], cfg)
    for line in lines:
        print(line, flush=True)
    for phase, name, label in ((phase_k7, "sort_pairs", ROUTES[1][0]),
                               (phase_k8, "counting_sort", ROUTES[0][0])):
        entry, lines = phase(calls[name], flush, clock_mhz, n_sm)
        entry["launches"] = route_launches[label][entry["name"]]
        for line in lines:
            print(line, flush=True)
        print_timing(entry)
        kernels.append(entry)
    del pool, cams, gts, seen, calls

    for phase in (phase_k9, phase_k10):
        entries, lines = phase(device, flush, clock_mhz, n_sm)
        for line in lines:
            print(line, flush=True)
        for entry in entries:
            print_timing(entry)
        kernels += entries
    kernels.sort(key=lambda e: (int(re.match(r"K(\d+)", e["name"]).group(1)), e["name"]))

    keep = {}
    for line in phase_driver(device, keep):
        print(line, flush=True)
    for line in phase_eval(device, keep):
        print(line, flush=True)
    del keep
    for phase in (phase_cli, phase_train_cli, phase_bench_cli, phase_train_cli_flags,
                  phase_eval_cli, phase_gate):
        for line in phase():
            print(line, flush=True)
    for line in phase_colmap(device, smi):
        print(line, flush=True)
    for line in phase_bench_scene(smi):
        print(line, flush=True)
    for line in phase_viewer(device, smi):
        print(line, flush=True)
    for line in phase_multidevice(device, smi):
        print(line, flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
