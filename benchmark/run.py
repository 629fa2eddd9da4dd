"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (kernel build, scene, warm-up) counts as ``setup_s``; the window then
measures for ``--seconds``; the comparison with the plain reference runs
after it. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error). Without a CUDA device the run fails and
prints no result; so it does where the run has loaded JAX or the JAX
package.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root in place of the script's folder, whose module names
# (trace, stats) would shadow the standard library's
sys.path[0] = str(ROOT)


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()

    from benchmark import harness

    spec = harness.load_spec()
    chips = harness.cell_entry(spec, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 T_PROC)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    if run.profile_lost:
        print(f"profile: {run.profile_lost}", file=sys.stderr)
    # seconds from the process's start; the window's gc; its rate and p95 by
    # stretch and whole, on the host's clock; the device clock's chunks
    for key in ("setup_phases", "server_gc", "window_stretches", "host_window", "device_clock"):
        if key in run.data:
            print(f"{key}: {json.dumps(run.data[key])}", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
