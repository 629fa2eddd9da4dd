"""K3's time on rows of several lengths, to compare two checkouts of the port
on one card.

Run as

    python easygaussiansplatting_tpu_torch/probes/scan_sizes.py [--root DIR]

DIR (default: the checkout that holds this file) is the root of the checkout
whose ``easygaussiansplatting_tpu_torch.ops.kernels.scan.multi_cumsum`` is
timed; its kernels build from that checkout's sources. For each [rows, m] of
SHAPES -- the three calls of a render at the bench budgets, and three far
longer rows -- int32 rows with binning's sparse marks (seed 0) are scanned,
checked equal to ``torch.cumsum``, and timed by CUDA events, the L2 flushed
before each call, beside one 1-D ``torch.cumsum`` a row (CUB's device scan).
A line a shape, then, last, one JSON object with the times, DIR and the
card's name and power limit. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

SHAPES = ((2, 229376), (1, 229376), (2, 557056), (2, 2**21), (1, 2**24), (1, 2**26))
ITERS = 20


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_sizes: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from easygaussiansplatting_tpu_torch.ops.kernels import scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    buf = torch.zeros(96 * 2**20 // 4, dtype=torch.int32, device="cuda")  # > the 50 MB L2
    gen = torch.Generator().manual_seed(0)
    torch.cuda._sleep(int(2e9))  # a second of spinning first, so the clocks have risen
    rows = []
    for r, m in SHAPES:
        x = torch.randint(-3, 4, (r, m), generator=gen, dtype=torch.int32)
        x = torch.where(torch.rand((r, m), generator=gen) < 0.3, x, 0).cuda()
        if not torch.equal(scan.multi_cumsum(x), torch.cumsum(x, 1, dtype=torch.int32)):
            raise RuntimeError(f"K3 differs from torch.cumsum on {(r, m)}")
        ms = event_ms(lambda: scan.multi_cumsum(x), buf.bitwise_not_)
        cub = event_ms(lambda: [torch.cumsum(v, 0, dtype=torch.int32) for v in x],
                       buf.bitwise_not_)
        print(f"[{r}, {m}]: K3 {ms:.4f} ms, a 1-D torch.cumsum a row {cub:.4f} ms", flush=True)
        rows.append({"rows": r, "m": m, "ms": ms, "cub_ms": cub})
    print(smi)
    print(json.dumps({"root": args.root, "device": smi, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
