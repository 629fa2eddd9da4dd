"""The harness: finds a cell's files by name, runs its driver once, reads its
metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own under the benchmark's folder, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration's sizes, its ``source``,
  ``reduced`` and ``assumed``;
* ``workloads/<cell>.json``: the cell's traffic mix, naming its
  configuration and the driver (``drivers/<driver>.py``) that runs it, and
  the limits of its comparison;
* ``metrics/<metric>.py``: one reader a metric, ``read(run) -> number or
  None`` (None: nothing to read, and the metric is left out of the line).

A cell or a metric is added by adding such files and entries in
``BENCHMARK.json``; no file here changes.
"""

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

from benchmark.trace import Spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "easygaussiansplatting_tpu")


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver measured and what the readers
    and the comparison read."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    t_proc: float
    config: dict
    workload: dict
    device: str = "cuda"
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: float = None
    window_s: float = None
    attempted: int = 0
    failed: int = 0
    data: dict = dataclasses.field(default_factory=dict)
    profile: dict = None
    profile_lost: str = None
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    memory_peak: int = 0
    memo: dict = dataclasses.field(default_factory=dict)

    def check(self, name, value, limit):
        """A number compared with its limit: ``value <= limit`` passes."""
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self):
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)

    def cached(self, key, fn):
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]


def load_spec(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_data(kind, name, bench=BENCH):
    return json.loads((Path(bench) / kind / f"{name}.json").read_text())


def load_reader(name, bench=BENCH):
    """The module of ``metrics/<name>.py``, loaded from its file."""
    path = Path(bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name):
    return importlib.import_module(f"benchmark.drivers.{name}")


def cell_entry(spec, cell):
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload named {cell!r} in BENCHMARK.json")


def end_to_end_of(spec, cell):
    """The cell's end-to-end metrics: those without ``workloads`` and those
    that list it."""
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(spec, cell):
    """The cell's per-layer metrics: those that list it, and those without
    ``workloads`` that move an end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the program's package name begins with the JAX package's)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed, seconds, trace, t_proc, root=ROOT, bench=BENCH, device="cuda"):
    """Run ``cell`` once: its driver's set-up and window, the comparison,
    and the readers. Returns (Run, the result line's dict)."""
    spec = load_spec(root)
    entry = cell_entry(spec, cell)
    workload = load_data("workloads", cell, bench)
    config = load_data("configs", entry["config"], bench)
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace), t_proc=t_proc,
              config=config, workload=workload, device=device)
    load_driver(workload["driver"]).run(run)
    wanted = per_layer_of(spec, cell) if trace else end_to_end_of(spec, cell)
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"], bench).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_info(run)}
    if trace and run.profile is not None:
        from benchmark.trace import breakdown

        line["breakdown"] = breakdown(run.profile)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return run, line


def device_info(run):
    import torch

    if run.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": int(run.memory_peak)}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(run.memory_peak), "power_limit": power_limit()}
    if run.trace and run.profile is not None:
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["window_s"]
    return info


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
