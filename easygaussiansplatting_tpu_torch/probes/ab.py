"""What the A/B probes share.

``probes/probe_times.py`` and ``probes/scan_sizes.py`` time the kernels of a
checkout of the port named by ``--root DIR`` (default: their own), so that
two checkouts can be compared on one card; ``probes/chunk_stop.py`` prints
the card beside its result. This module holds what they have in common:

- :func:`add_root` and :func:`import_root`: the ``--root`` option, and DIR's
  modules imported from DIR (their kernels then build from DIR's sources);
- :func:`card`: the card's name and power limit, as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them;
- :func:`make_flush`: what runs before each timed call, by mode: ``write``
  overwrites a 96 MB buffer (more than the 50 MB L2, which it leaves full of
  dirty lines, as ``chip_smoke.py`` flushes), ``read`` reads it (the L2 left
  clean), ``none`` nothing (the call's data may stay in the L2);
- :func:`event_ms`: the mean device time of a call by CUDA events;
- :func:`device_us`: the device time of a call's kernels by ``torch.profiler``.

The two timing scripts run as files and import this module from their own
directory before DIR's package, so both checkouts are timed by one harness.
It imports nothing of the package.
"""

import importlib
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout that holds this file
ITERS = 20            # calls an events timing
PROFILED_CALLS = 10   # calls a profiler window
FLUSHES = ("write", "read", "none")


def add_root(ap):
    """The ``--root DIR`` option of an A/B probe's parser."""
    ap.add_argument("--root", default=str(ROOT))


def import_root(root, *names):
    """The modules ``easygaussiansplatting_tpu_torch.<name>`` of the checkout
    at ``root``, imported from there. Raises if the package was already
    imported from elsewhere (a probe run with ``-m`` from another checkout)."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    mods = [importlib.import_module(f"easygaussiansplatting_tpu_torch.{n}") for n in names]
    for m in mods:
        if root not in Path(m.__file__).resolve().parents:
            raise RuntimeError(f"{m.__name__} was imported from {m.__file__}, not from {root}: "
                               f"run the probe as a file")
    return mods


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def make_flush(mode):
    """The function run before each timed call under ``mode`` (FLUSHES)."""
    buf = torch.zeros(96 * 2**20 // 4, dtype=torch.int32, device="cuda")  # > the 50 MB L2
    return {"write": buf.bitwise_not_, "read": lambda: buf.max(), "none": lambda: None}[mode]


def event_ms(fn, flush):
    """Mean device time of fn() between CUDA events, the L2 flushed before
    each call outside the events; a spin kernel holds the device while the
    host queues the calls, so the events time the device's work alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.0, 4 * ITERS * (time.perf_counter() - t0)) * 2e9))
    marks = []
    for _ in range(ITERS):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / ITERS


def _kernel_us(fn, flush):
    """{kernel name: device microseconds} over PROFILED_CALLS calls of fn(),
    each after flush(), in one torch.profiler window."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED_CALLS):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


def device_us(fn, flush):
    """Device microseconds of fn()'s kernels a call, by torch.profiler over
    PROFILED_CALLS calls, each after flush(); the kernels that flush()
    launches are left out by name."""
    skip = set(_kernel_us(lambda: None, flush))
    return sum(us for k, us in _kernel_us(fn, flush).items() if k not in skip) / PROFILED_CALLS
