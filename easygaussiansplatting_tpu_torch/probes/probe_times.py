"""K9's and K10's times at their scripts' sizes, to compare two checkouts of
the port on one card.

Run as

    python easygaussiansplatting_tpu_torch/probes/probe_times.py [--root DIR]
        [--flush write|read|none]

DIR (default: the checkout that holds this file) is the root of the checkout
whose probes (``probes/micro_bench.py``, ``probes/exp_dma_stream.py``) are
timed; its kernels build from that checkout's sources. On the scripts'
inputs each kernel is first held against its plain version as
``chip_smoke.py`` holds it (K9a zeros, K9b bit-equal, K9v within 1e-6 and
K10 within 1e-5 of the sums of |x| behind each value), then timed twice
(``REPS``) by DIR's ``scan_sizes.event_ms``: CUDA events around 20 calls,
the L2 flushed before each (``--flush``: by overwriting a 96 MB buffer, as
``chip_smoke.py`` does, by reading it, or not at all), and once by
``torch.profiler``: the device time of its kernels in 10 such calls. A
one-element add, timed alike, gives the harness's floor. A line a kernel,
then, last, one JSON object with the times, DIR and the card's name and
power limit. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPS = 2  # event timings a kernel, to show their spread
PROFILED_CALLS = 10


def device_times(fn, flush):
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


def close(got, want, mag, rtol):
    return bool(((got - want).abs() <= rtol * mag).all())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--flush", choices=("write", "read", "none"), default="write",
                    help="before each call: overwrite a 96 MB buffer (the default, as "
                         "chip_smoke.py does; it leaves the L2 full of dirty lines), read it "
                         "(the L2 left clean), or nothing (the call's data stays in L2)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from easygaussiansplatting_tpu_torch.probes import exp_dma_stream, micro_bench
    from easygaussiansplatting_tpu_torch.probes.scan_sizes import event_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    buf = torch.zeros(96 * 2**20 // 4, dtype=torch.int32, device="cuda")  # > the 50 MB L2
    flush = {"write": buf.bitwise_not_, "read": lambda: buf.max(), "none": lambda: None}[
        args.flush]
    q, nt = micro_bench.Q_TOTAL, micro_bench.N_TILES
    packed, tiles, _ = micro_bench.make_inputs("cuda")
    x, offs, rows = (torch.from_numpy(a).cuda() for a in exp_dma_stream.make_inputs())
    img_p, _ = micro_bench.variant_b_plain(q, nt, packed, tiles)
    checks = {
        "K9a variant_a": torch.equal(micro_bench.variant_a(q, packed, tiles),
                                     torch.zeros((8, 128), device="cuda")),
        "K9b variant_b": torch.equal(micro_bench.variant_b(q, nt, packed, tiles)[0], img_p),
        "K9v variant_vmem_resident": close(
            micro_bench.variant_vmem_resident(q, nt, packed, tiles),
            micro_bench.variant_vmem_resident_plain(q, nt, packed, tiles),
            micro_bench.variant_vmem_resident_plain(q, nt, packed.abs(), tiles), 1e-6),
        "K10 stream_sums": close(
            exp_dma_stream.stream_sums(offs, rows, x),
            exp_dma_stream.stream_sums_plain(offs, rows, x),
            exp_dma_stream.stream_sums_plain(offs, rows, x.abs()), 1e-5),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"differ from their plain versions: {failed}")
    one = torch.zeros(1, device="cuda")
    calls = {
        "floor: a 1-element add": lambda: one.add_(1),
        "K9a variant_a": lambda: micro_bench.variant_a(q, packed, tiles),
        "K9b variant_b": lambda: micro_bench.variant_b(q, nt, packed, tiles),
        "K9v variant_vmem_resident": lambda: micro_bench.variant_vmem_resident(
            q, nt, packed, tiles),
        "K10 stream_sums": lambda: exp_dma_stream.stream_sums(offs, rows, x),
    }
    torch.cuda._sleep(int(2e9))  # a second of spinning first, so the clocks have risen
    flush_names = set(device_times(lambda: None, flush))
    times, device = {}, {}
    for name, fn in calls.items():
        times[name] = [event_ms(fn, flush) for _ in range(REPS)]
        device[name] = sum(us for k, us in device_times(fn, flush).items()
                           if k not in flush_names) / PROFILED_CALLS
        print(f"{name}: " + " / ".join(f"{ms:.4f}" for ms in times[name]) + " ms by events, "
              f"{device[name]:.2f} us of device kernels a call (profiler)", flush=True)
    print(smi)
    print(json.dumps({"root": args.root, "flush": args.flush, "device": smi, "ms": times,
                      "device_us": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
