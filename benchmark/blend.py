"""What the blend kernels' (K4, K5) profiled calls needed, counted by the
frozen arithmetic of :mod:`benchmark.counting` on the inputs that every
``STRIDE``-th call of the profiled stretch was kept with (counting a frame's
work takes longer than the frame, and each kept call holds its buffers),
for the per-layer readers, and set against the same calls' device records:
a wrapper launches one kernel a call and the profile's records equal the
launches, so the k-th record is the k-th call's. Each count is made once a
run."""

import functools
import subprocess

import torch

from benchmark import counting

STRIDE = 5


@functools.lru_cache(maxsize=1)
def chip():
    """(the SM clock's maximum in MHz, the number of SMs) of device 0."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    return (float(out.stdout.strip().splitlines()[0].split()[0]),
            torch.cuda.get_device_properties(0).multi_processor_count)


def _keeper(run, kind):
    return run.data.get("profile", {}).get("kept", {}).get("rasterize_" + kind)


def _calls(run, kind):
    keeper = _keeper(run, kind)
    return keeper.calls if keeper is not None else []


def device_s(run, kind):
    """Device seconds of the counted calls' kernels."""
    name = "rasterize_fwd_kernel" if kind == "fwd" else "rasterize_bwd_kernel"
    return sum(run.profile["each"].get(name, [])[::STRIDE])


def scale(run, kind):
    """Calls kept over calls counted: the counted work's multiplier to the
    whole profiled stretch."""
    keeper = _keeper(run, kind)
    return keeper.n / max(1, len(keeper.calls)) if keeper is not None else 0.0


def _counts(args, kw):
    table, patch_gsid, tile_start, tile_cnt = args[:4]
    kept = int(tile_cnt.sum())
    distinct = int(torch.unique(patch_gsid[:kept]).numel()) if kept else 0
    return kept, tile_cnt.numel(), distinct, kw["width"] * kw["height"]


def works(run, kind):
    """blend_work of every kept call of K4 (``kind`` "fwd") or K5 ("bwd")."""
    def count():
        out = []
        for args, kw, res in _calls(run, kind):
            table, patch_gsid, tile_start, tile_cnt = args[:4]
            w, h = kw["width"], kw["height"]
            if kind == "fwd":
                walk = counting.k4_walk(tile_cnt, res[1], res[2], w, h)
            else:
                walk = args[6]
            out.append(counting.blend_work(table, patch_gsid, tile_start, tile_cnt, walk, w, h))
        return out

    return run.cached(("blend_work", kind), count)


def k4_bounds(run):
    clock, n_sm = chip()
    return [counting.k4_bound(counting.k4_bytes(*_counts(args, kw)), work, clock, n_sm)
            for (args, kw, _), work in zip(_calls(run, "fwd"), works(run, "fwd"))]


def k5_bounds(run):
    clock, n_sm = chip()
    return [counting.k5_bound(counting.k5_bytes(*_counts(args, kw), args[1].numel()), work,
                              clock, n_sm)
            for (args, kw, _), work in zip(_calls(run, "bwd"), works(run, "bwd"))]
