"""K10: row sums over 128-row chunks read at runtime offsets.

Port of scripts/exp_dma_stream.py, run as

    python -m easygaussiansplatting_tpu_torch.probes.exp_dma_stream [--device cpu]

At the script's sizes (x [2^18, 16] float32, 4,096 chunks, offsets in
[0, m - 128) and row counts in [1, 128], all from ``default_rng(0)``) it
computes ``out[c] = x[offs[c]:offs[c] + rows[c]].sum(0)``, checks it against
numpy, prints ``max err: ... OK`` or ``FAIL`` and the time per chunk, and
exits non-zero on FAIL.

The kernel (``csrc/dma_stream.cu``) is Hopper's counterpart of the Pallas
kernel's DMA and semaphores: a block takes 8 consecutive chunks through a
ring of 4 shared-memory slots, one a warp, each filled by one TMA bulk copy
of exactly the ``rows[c]`` rows that are summed and reported by an
``mbarrier`` (``csrc/tma.cuh``). Its plain PyTorch version, :func:`stream_sums_plain`,
gathers and sums. CPU tensors take the plain version; CUDA tensors launch
the kernel, and ``x`` must then be 16-byte aligned (a bulk copy's source
is). As in the script, a chunk reads ``x[offs[c]:offs[c] + 128]``, so
``offs`` must lie in [0, m - 128] and ``rows`` in [1, 128]; the plain
version checks both and raises, and the kernel clamps them (``offs`` into
[0, m - 128], ``rows`` into [0, 128]), so it never reads outside ``x``.
:func:`kernel_info` gives what the compiled kernel takes on the card.
"""

import argparse
import ctypes
import time

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.utils.device import resolve_device, synchronize

K = 128     # rows of a chunk
COLS = 16   # columns of x
M, Q_TOTAL = 1 << 18, 4096
OK_TOL = 1e-3  # the script's verdict threshold on the max abs error


def _check_layout(offs, rows, x):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != COLS or x.shape[0] < K:
        raise ValueError(f"x must be float32 [m >= {K}, {COLS}], got {x.dtype} {tuple(x.shape)}")
    for name, t in (("offs", offs), ("rows", rows)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != offs.shape:
            raise ValueError(f"{name} must be int32 [q] like offs, got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() and t.device == x.device for t in (offs, rows, x)):
        raise ValueError("offs, rows and x must be contiguous and on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def stream_sums_plain(offs, rows, x):
    """Plain PyTorch version of K10: out [q, 1, 16]."""
    m = x.shape[0]
    if offs.numel() and (int(offs.min()) < 0 or int(offs.max()) > m - K):
        raise ValueError(f"offs must lie in [0, {m - K}]: a chunk reads {K} rows")
    if rows.numel() and (int(rows.min()) < 1 or int(rows.max()) > K):
        raise ValueError(f"rows must lie in [1, {K}]")
    r = torch.arange(K, device=x.device)
    block = x[offs.long()[:, None] + r]  # [q, K, 16]
    return torch.where((r[None, :] < rows[:, None])[..., None], block, 0.0).sum(
        dim=1, keepdim=True)


def stream_sums(offs, rows, x):
    """K10: ``out[c] = x[offs[c]:offs[c] + rows[c]].sum(0)`` as [q, 1, 16],
    the Pallas kernel's output layout."""
    _check_layout(offs, rows, x)
    if x.device.type == "cpu":
        return stream_sums_plain(offs, rows, x)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned: the kernel copies it by TMA bulk copies")
    q = offs.shape[0]
    out = torch.empty((q, 1, COLS), dtype=torch.float32, device=x.device)
    if q == 0:
        return out
    _build.check(_build.library().egs_stream_sums(
        x.data_ptr(), x.shape[0], offs.data_ptr(), rows.data_ptr(), q, out.data_ptr(),
        _build.stream_ptr(x)), "egs_stream_sums")
    stream_sums.launches += 1
    return out


stream_sums.launches = 0

INFO_KEYS = ("registers", "shared_bytes", "local_bytes", "blocks_per_sm", "threads", "stages",
             "chunks_per_block")


def kernel_info():
    """What the compiled K10 kernel takes on the card: {"registers": per
    thread, "shared_bytes": per block, "local_bytes": per thread (spills),
    "blocks_per_sm": resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "threads": per block,
    "stages": slots of its ring, "chunks_per_block"}. Builds the kernels
    first if needed; needs the card."""
    out = (ctypes.c_int * len(INFO_KEYS))()
    _build.check(_build.library().egs_stream_sums_info(ctypes.addressof(out)),
                 "egs_stream_sums_info")
    return dict(zip(INFO_KEYS, out))


def make_inputs(m=M, q_total=Q_TOTAL):
    """x, offs and rows as numpy arrays, as the script makes them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, COLS)).astype(np.float32)
    offs = rng.integers(0, m - K, size=q_total).astype(np.int32)
    rows = rng.integers(1, K + 1, size=q_total).astype(np.int32)
    return x, offs, rows


def run(device="cuda", m=M, q_total=Q_TOTAL):
    """The script's check and timing on ``device``. Returns (max abs error
    against numpy, best ms per call of 10)."""
    dev = resolve_device(device)
    x, offs, rows = make_inputs(m, q_total)
    xt, ot, rt = (torch.from_numpy(a).to(dev) for a in (x, offs, rows))
    t0 = time.perf_counter()
    out = stream_sums(ot, rt, xt)
    synchronize(dev)
    print(f"first call (kernel build included) {time.perf_counter() - t0:.1f}s")
    want = np.stack([x[o:o + K][:r].sum(0) for o, r in zip(offs, rows)])
    err = float(np.abs(out.cpu().numpy()[:, 0, :] - want).max())
    print("max err:", err, "OK" if err < OK_TOL else "FAIL")
    best = 1e9
    for _ in range(3):
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            out = stream_sums(ot, rt, xt)
        synchronize(dev)
        best = min(best, (time.perf_counter() - t0) / 10)
    print(f"{q_total} chunked async reads of [{K},{COLS}]: {best * 1e3:.3f} ms "
          f"({best * 1e9 / q_total:.1f} ns/chunk)")
    return err, best * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    err, _ = run(args.device)
    return 0 if err < OK_TOL else 1


if __name__ == "__main__":
    raise SystemExit(main())
