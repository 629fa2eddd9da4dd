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
import sys

import torch

if __package__:
    from . import ab
else:  # run as a file: its directory is on sys.path
    import ab

SHAPES = ((2, 229376), (1, 229376), (2, 557056), (2, 2**21), (1, 2**24), (1, 2**26))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ab.add_root(ap)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_sizes: needs a CUDA device", file=sys.stderr)
        return 2
    scan, = ab.import_root(args.root, "ops.kernels.scan")
    smi = ab.card()
    flush = ab.make_flush("write")
    gen = torch.Generator().manual_seed(0)
    torch.cuda._sleep(int(2e9))  # a second of spinning first, so the clocks have risen
    rows = []
    for r, m in SHAPES:
        x = torch.randint(-3, 4, (r, m), generator=gen, dtype=torch.int32)
        x = torch.where(torch.rand((r, m), generator=gen) < 0.3, x, 0).cuda()
        if not torch.equal(scan.multi_cumsum(x), torch.cumsum(x, 1, dtype=torch.int32)):
            raise RuntimeError(f"K3 differs from torch.cumsum on {(r, m)}")
        ms = ab.event_ms(lambda: scan.multi_cumsum(x), flush)
        cub = ab.event_ms(lambda: [torch.cumsum(v, 0, dtype=torch.int32) for v in x], flush)
        print(f"[{r}, {m}]: K3 {ms:.4f} ms, a 1-D torch.cumsum a row {cub:.4f} ms", flush=True)
        rows.append({"rows": r, "m": m, "ms": ms, "cub_ms": cub})
    print(smi)
    print(json.dumps({"root": args.root, "device": smi, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
