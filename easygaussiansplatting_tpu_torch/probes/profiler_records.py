"""Which device records torch.profiler loses, and after what.

Run as

    python -m easygaussiansplatting_tpu_torch.probes.profiler_records

Each case runs in a process of its own: a prefix of calls (CASES), then
WINDOWS profiled windows, each of ROUNDS rounds of one fixed sequence of
device work -- K1 on 65,536 gaussians (data/fixtures.py::preprocess_case, SH
degree 3), K3 on [2, 229,376] int32 rows (a memset and a kernel), one torch
add -- each round after a synchronise. Every activity of a window is known,
so each window's device records are held against the sequence, and the
records it lacks are printed by position and name. The cases are the calls
that chip_smoke.py makes before its profiles:

* ``none``: the warm round alone;
* ``profiled_k3``: five windows of one K3 call each first, as the K3
  phase's kernel counts take them;
* ``kernel_info``: K1's and K2's compiled attributes at SH degrees 0-5
  (cudaFuncGetAttributes, cudaFuncSetAttribute, the occupancy query);
* ``profiled_cub``: one window of a 1-D torch.cumsum (CUB's scan);
* ``all``: the three prefixes in that order;
* ``render``: no prefix; a round is one render of chip_smoke.py's bench
  view instead (65,536 gaussians, SH degree 3, 979x546, max_patches
  557,056, max_rows 229,376; ops/rasterize.py::render, as its render
  profile runs it);
* ``render_marker``: as ``render``, with one torch add run first in each
  window, so that a render's first kernel is not the window's first
  record;
* ``smoke``: chip_smoke.py's own phases before its render profile
  (``phase_slice``, then ``phase_k1``, ``phase_k3`` and ``phase_k4``, as
  its ``main`` runs them), then windows of its render; ``smoke_no_k1``,
  ``smoke_no_k3`` and ``smoke_no_k4`` leave out one phase each, and
  ``smoke_slice`` all three. ``smoke_k3_sass`` and ``smoke_k3_k4info``
  follow ``phase_k3`` with one part of ``phase_k4`` alone (the cuobjdump
  read of K4's inner loop, ``sass_loop``; K4's compiled attributes,
  ``kernel_info_line``), and ``smoke_sass_k3`` runs the cuobjdump read
  before ``phase_k3``. These cases import chip_smoke.py, so they run from
  the repository's root.

A line a case, then, last, one JSON object with the records lost in each
window of each case and the card's name and power limit. Needs a CUDA
device.
"""

import argparse
import difflib
import json
import subprocess
import sys

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data import example_camera
from easygaussiansplatting_tpu_torch.data.fixtures import preprocess_case
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.models.convert import gaussians_from_numpy
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess, scan
from easygaussiansplatting_tpu_torch.ops.rasterize import render

# the chip_smoke.py steps each smoke case runs before its render windows
SMOKE_PHASES = {"smoke": ("k1", "k3", "k4"), "smoke_no_k1": ("k3", "k4"),
                "smoke_no_k3": ("k1", "k4"), "smoke_no_k4": ("k1", "k3"), "smoke_slice": (),
                "smoke_k3_sass": ("k3", "sass"), "smoke_k3_k4info": ("k3", "k4info"),
                "smoke_sass_k3": ("sass", "k3")}
CASES = ("none", "profiled_k3", "kernel_info", "profiled_cub", "all", "render",
         "render_marker", *SMOKE_PHASES)
WINDOWS, ROUNDS = 4, 5
ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def device_names(prof):
    """The window's device records (kernels and memsets) in time order, by
    short name."""
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            .split(" ")[-1].split("::")[-1] for e in events]


def run_case(case):
    params = {k: torch.from_numpy(v).cuda() for k, v in preprocess_case(65536, 3).items()}
    args = [params[k] for k in ("pws", "shs", "alphas", "scales", "rots")]
    cam = Camera.from_dict(example_camera())
    rows = torch.randint(-3, 4, (2, 229376), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32).cuda()
    a = torch.ones(4096, device="cuda")

    def one_round():
        preprocess.preprocess_fwd(*args, cam, sh_degree=3)
        scan.multi_cumsum(rows)
        a.add_(1.0)

    if case.startswith("render"):
        scene = make_synthetic_scene(seed=0, n_gaussians=65536, n_cams=4, width=979, height=546,
                                     log_scale_mean=-3.6)
        shs = np.zeros((65536, 48), np.float32)
        shs[:, :3] = scene["shs"]
        g = gaussians_from_numpy({**scene, "shs": shs}, "cuda")
        view = [g[k] for k in ("pws", "shs", "alphas", "scales", "rots")]

        def one_round():
            render(*view, scene["cameras"][0], sh_degree=3, max_patches=557056,
                   max_rows=229376, need_grads=False, device="cuda")

    if case in SMOKE_PHASES:
        import chip_smoke

        torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's main sets them
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda")
        clock_mhz = float(chip_smoke.nvidia_smi("clocks.max.sm").split()[0])
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        _, _, (one_round, _) = chip_smoke.phase_slice(device)
        flush = chip_smoke.make_flush(device)
        steps = {"sass": lambda: chip_smoke.sass_loop("rasterize_fwd_kernel"),
                 "k4info": lambda: chip_smoke.kernel_info_line("K4", "fwd")}
        for name in SMOKE_PHASES[case]:
            if name in steps:
                steps[name]()
            else:
                getattr(chip_smoke, f"phase_{name}")(device, flush, clock_mhz, n_sm)

    one_round()
    torch.cuda.synchronize()
    if case in ("profiled_k3", "all"):
        for _ in range(5):
            with torch.profiler.profile(activities=ACTS):
                scan.multi_cumsum(rows)
                torch.cuda.synchronize()
    if case in ("kernel_info", "all"):
        for kernel in ("fwd", "bwd"):
            for deg in range(6):
                preprocess.kernel_info(kernel, deg)
    if case in ("profiled_cub", "all"):
        with torch.profiler.profile(activities=ACTS):
            torch.cumsum(rows[0], 0, dtype=torch.int32)
            torch.cuda.synchronize()

    def window(rounds):
        with torch.profiler.profile(activities=ACTS) as prof:
            if case == "render_marker":
                a.add_(1.0)
                torch.cuda.synchronize()
            for _ in range(rounds):
                one_round()
                torch.cuda.synchronize()
        return device_names(prof)

    windows = [window(ROUNDS) for _ in range(WINDOWS)]
    # what a window holds: the last round of a longer window, taken after
    # the measured ones, ROUNDS times (after the marker's record)
    names = window(2 * ROUNDS)
    marker = names[:1] if case == "render_marker" else []
    want = marker + names[-round((len(names) - len(marker)) / (2 * ROUNDS)):] * ROUNDS
    lost = []
    for got in windows:
        sm = difflib.SequenceMatcher(a=want, b=got, autojunk=False)
        lost.append([f"{i}:{want[i]}" for tag, i1, i2, _, _ in sm.get_opcodes()
                     if tag in ("delete", "replace") for i in range(i1, i2)])
    return {"case": case, "records_a_window": len(want), "lost": lost}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=CASES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_records: needs a CUDA device", file=sys.stderr)
        return 2
    if args.case:
        print(json.dumps(run_case(args.case)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    results = []
    for case in CASES:
        out = subprocess.run([sys.executable, "-m", __spec__.name, "--case", case],
                             capture_output=True, text=True, check=True, timeout=600)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{case}: {res['records_a_window']} records a window; lost by window "
              f"{res['lost']}", flush=True)
        results.append(res)
    print(smi)
    print(json.dumps({"device": smi, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
