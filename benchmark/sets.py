"""Sets of runs of the benchmark's cells, and their spreads.

    python3 benchmark/sets.py --cells A,B --seeds 11,12,13 [--seconds 51,51] \\
        [--trace 0] [--roots .,build/parent] [--log build/sets.jsonl]

Runs ``benchmark/run.py`` of each checkout in ``--roots`` (the current one by
default) as its own process, one after another: one set for each window
length in ``--seconds``, in that order, and in each set, for each cell and
each seed, every root in turn, so that checkouts alternate on the same
seeds. A short run of each cell and root comes first and is not counted
(the first run of a checkout builds the kernels). Each run's result
line, its wall time and the lines it prints on standard error are appended
to ``--log`` as one JSON object; the summary at the end gives, for each
root (by its place in ``--roots``, so that a root named twice makes two
sides), cell and set, each metric's median, its spread (``stats.spread``)
and its quartile spread (``stats.quartile_spread``), and the runs that
were correct.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # the checkout's root in place of the script's folder
    sys.path[0] = str(ROOT)

from benchmark import stats  # noqa: E402

STDERR_KEYS = ("setup_phases", "server_gc", "window_stretches", "host_window", "device_clock")
TIMEOUT_S = 1200  # a run's limit, the first run's compile included


def one_run(root, cell, seed, seconds, trace):
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    try:
        out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=TIMEOUT_S)
        rc, stdout, stderr = out.returncode, out.stdout, out.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = "timeout", e.stdout or "", e.stderr or ""
    rec = {"root": str(root), "cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
           "rc": rc, "wall_s": time.perf_counter() - t, "at": time.time()}
    lines = stdout.strip().splitlines() if isinstance(stdout, str) else []
    try:
        rec["line"] = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        rec["line"] = None
    for text in stderr.splitlines() if isinstance(stderr, str) else []:
        key, _, rest = text.partition(": ")
        if key in STDERR_KEYS:
            rec[key] = json.loads(rest)
    if rec["line"] is None:
        rec["stderr_tail"] = stderr[-4000:] if isinstance(stderr, str) else ""
    return rec


def summary(recs):
    """{"side|cell|set": {metric: {median, spread, quartile spread, min,
    max}, ...}} with the count of correct runs; the window's rate and p95
    on the host's clock, which standard error gives in every run, count as
    metrics named ``host.<name>``. A side is a root's place in ``--roots``
    and its path, as "1:/path"."""
    groups = {}
    for r in recs:
        groups.setdefault((r["side"], r["cell"], r["set"]), []).append(r)
    out = {}
    for key, rs in sorted(groups.items()):
        lines = [r["line"] for r in rs if r["line"]]
        values = [{m: v["value"] for m, v in r["line"]["metrics"].items()}
                  | {f"host.{m}": v for m, v in r.get("host_window", {}).items()}
                  for r in rs if r["line"]]
        names = sorted({m for v in values for m in v})
        row = {"runs": len(rs), "correct": sum(bool(ln["correct"]) for ln in lines)}
        for m in names:
            v = [x[m] for x in values if m in x]
            row[m] = {"median": statistics.median(v), "spread": stats.spread(v),
                      "quartile_spread": stats.quartile_spread(v) if len(v) > 1 else 0.0,
                      "min": min(v), "max": max(v)}
        out["|".join(map(str, key))] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="51,51", help="one set for each window length")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--roots", default=".")
    ap.add_argument("--log", default="build/sets.jsonl")
    args = ap.parse_args(argv)
    cells = args.cells.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    windows = [float(s) for s in args.seconds.split(",")]
    roots = [(ROOT / r).resolve() for r in args.roots.split(",")]
    log = Path(args.log)
    log.parent.mkdir(parents=True, exist_ok=True)
    recs = []
    with log.open("a") as f:
        def keep(rec):
            f.write(json.dumps(rec) + "\n")
            f.flush()
            ln = rec["line"] or {}
            brief = {k: rec.get(k) for k in ("side", "cell", "set", "seed", "rc", "wall_s")}
            brief["correct"] = ln.get("correct")
            brief["metrics"] = {m: v["value"] for m, v in ln.get("metrics", {}).items()}
            print(json.dumps(brief), flush=True)

        for cell in cells:
            for i, root in enumerate(roots):
                keep(one_run(root, cell, seeds[0] + 1, 5, 0) | {"side": f"{i}:{root}",
                                                                 "set": "warm"})
        for s, seconds in enumerate(windows):
            for cell in cells:
                for seed in seeds:
                    for i, root in enumerate(roots):
                        rec = one_run(root, cell, seed, seconds, args.trace)
                        rec |= {"side": f"{i}:{root}", "set": s}
                        keep(rec)
                        recs.append(rec)
    print(json.dumps(summary(recs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
