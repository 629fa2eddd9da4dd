"""K3: multi-row inclusive cumulative sum.

Port of easygaussiansplatting_tpu/ops/pallas/scan.py (``multi_cumsum``,
``batched_cumsum``). The kernel is ``csrc/scan.cu``; its plain version is
``torch.cumsum`` along axis 1 with the input's dtype kept (torch would widen
int32 to int64 unless told otherwise; the JAX ints stay int32).

Unlike the Pallas kernel, which needs a length that is a multiple of its
16,384-lane block, the CUDA kernel takes any length.
"""

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build

MAX_ROWS = 8
TILE = 2048  # elements per block of csrc/scan.cu (THREADS * ITEMS)
_ENTRY = {torch.int32: "egs_multi_cumsum_i32", torch.float32: "egs_multi_cumsum_f32"}


def multi_cumsum_plain(rows):
    """Plain PyTorch version of K3."""
    return torch.cumsum(rows, dim=1, dtype=rows.dtype)


def multi_cumsum(rows):
    """Inclusive cumsum along axis 1 of an [R, M] int32/float32 tensor
    (R <= 8, any M). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
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
    n_blocks = -(-m // TILE)
    sums = torch.empty((r, n_blocks), dtype=rows.dtype, device=rows.device)
    name = _ENTRY[rows.dtype]
    _build.check(getattr(_build.library(), name)(
        rows.data_ptr(), out.data_ptr(), sums.data_ptr(), r, m, n_blocks,
        _build.stream_ptr(rows)), name)
    multi_cumsum.launches += 1
    return out


multi_cumsum.launches = 0


def batched_cumsum(arrays, cumsum=multi_cumsum):
    """Cumsum a list of equal-length 1D tensors in one call of ``cumsum``
    (one kernel launch; ``multi_cumsum_plain`` for the plain version)."""
    out = cumsum(torch.stack(arrays, dim=0))
    return [out[i] for i in range(len(arrays))]
