"""K3 and K6: multi-row inclusive cumulative sums, plain and segmented.

Port of easygaussiansplatting_tpu/ops/pallas/scan.py (``multi_cumsum``,
``batched_cumsum``, ``segmented_cumsum``). K3's kernel is ``csrc/scan.cu``;
its plain version is ``torch.cumsum`` along axis 1 with the input's dtype
kept (torch would widen int32 to int64 unless told otherwise; the JAX ints
stay int32). K6's kernel is ``csrc/seg_scan.cu``; its plain version is
:func:`segmented_cumsum_plain`. Each kernel's plan (tile, launches,
scratch) lives in C: :func:`multi_cumsum_plan` and
:func:`segmented_cumsum_plan` ask it.

Unlike the Pallas kernels, which need a length that is a multiple of their
16,384-lane block, the CUDA kernels take any length.
"""

import ctypes

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build

MAX_ROWS = 8
_ENTRY = {torch.int32: "egs_multi_cumsum_i32", torch.float32: "egs_multi_cumsum_f32"}


def multi_cumsum_plain(rows):
    """Plain PyTorch version of K3."""
    return torch.cumsum(rows, dim=1, dtype=rows.dtype)


def _plan(entry, m, rows):
    out = [ctypes.c_longlong() for _ in range(4)]
    _build.check(getattr(_build.library(), entry)(m, rows, *(ctypes.byref(v) for v in out)),
                 entry)
    return dict(zip(("tile", "launches", "memsets", "scratch"), (v.value for v in out)))


def multi_cumsum_plan(m, rows):
    """csrc/scan.cu's plan for a call on [rows, m]: {"tile": positions a
    block (of one row), "launches": kernel launches (one), "memsets":
    memsets of the tile counter and status words (one), "scratch": int32
    words}. Asks the kernel library, so it needs the CUDA toolkit."""
    return _plan("egs_multi_cumsum_plan", m, rows)


def multi_cumsum(rows):
    """Inclusive cumsum along axis 1 of an [R, M] int32/float32 tensor
    (R <= 8, any M). CPU tensors take the plain version; CUDA tensors
    launch the kernel (one launch after one memset, as
    :func:`multi_cumsum_plan` gives)."""
    if rows.dtype not in _ENTRY:
        raise TypeError(f"multi_cumsum takes int32 or float32, got {rows.dtype}")
    if rows.dim() != 2 or not 1 <= rows.shape[0] <= MAX_ROWS:
        raise ValueError(f"multi_cumsum takes [R<={MAX_ROWS}, M], got {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("multi_cumsum needs a contiguous tensor")
    if rows.device.type == "cpu":
        return multi_cumsum_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    r, m = rows.shape
    out = torch.empty_like(rows)
    if m == 0:
        return out
    # uninitialised: the C entry clears it
    scratch = torch.empty(multi_cumsum_plan(m, r)["scratch"], dtype=torch.int32,
                          device=rows.device)
    name = _ENTRY[rows.dtype]
    _build.check(getattr(_build.library(), name)(
        rows.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(), r, m,
        _build.stream_ptr(rows)), name)
    multi_cumsum.launches += 1
    return out


multi_cumsum.launches = 0


def batched_cumsum(arrays, cumsum=multi_cumsum):
    """Cumsum a list of equal-length 1D tensors in one call of ``cumsum``
    (one kernel launch; ``multi_cumsum_plain`` for the plain version)."""
    out = cumsum(torch.stack(arrays, dim=0))
    return [out[i] for i in range(len(arrays))]


def segmented_cumsum_plain(vals, flags):
    """Plain PyTorch version of K6: a float64 cumsum minus the running total
    where each segment starts (the start positions carried forward by a
    cummax), cast back to float32. In float64 no cross-segment cancellation
    reaches the float32 result."""
    m = vals.shape[1]
    idx = torch.arange(m, device=vals.device)
    seg_start = torch.cummax(torch.where(flags != 0, idx, 0), dim=0).values
    c = torch.cumsum(vals.double(), dim=1)
    return (c - (c - vals.double())[:, seg_start]).to(vals.dtype)


def segmented_cumsum_plan(m, rows):
    """csrc/seg_scan.cu's plan for a call on [rows, m]: {"tile": positions a
    block, "launches": kernel launches (one a group of 16 rows), "memsets":
    memsets of the scratch's counters and status words, "scratch": int32
    words}. Asks the kernel library, so it needs the CUDA toolkit."""
    return _plan("egs_segmented_cumsum_plan", m, rows)


def segmented_cumsum(vals, flags):
    """Inclusive segmented cumsum along axis 1 of an [R, M] float32 tensor
    (any R and M); ``flags`` [M] int32, nonzero where a segment starts
    (element 0 always starts one). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError(f"segmented_cumsum takes float32 [R, M], got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if flags.dtype != torch.int32 or tuple(flags.shape) != (vals.shape[1],):
        raise ValueError(f"flags must be int32 [{vals.shape[1]}], got {flags.dtype} "
                         f"{tuple(flags.shape)}")
    if not (vals.is_contiguous() and flags.is_contiguous()) or flags.device != vals.device:
        raise ValueError("segmented_cumsum needs contiguous tensors on one device")
    if vals.device.type == "cpu":
        return segmented_cumsum_plain(vals, flags)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    r, m = vals.shape
    out = torch.empty_like(vals)
    if r == 0 or m == 0:
        return out
    # uninitialised: the C entry clears the part that needs it
    scratch = torch.empty(segmented_cumsum_plan(m, r)["scratch"], dtype=torch.int32,
                          device=vals.device)
    _build.check(_build.library().egs_segmented_cumsum_f32(
        vals.data_ptr(), flags.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), r, m, _build.stream_ptr(vals)), "egs_segmented_cumsum_f32")
    segmented_cumsum.launches += 1
    return out


segmented_cumsum.launches = 0
