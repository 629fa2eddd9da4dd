"""K8: stable counting sort (LSD radix) of bounded int32 keys.

Port of easygaussiansplatting_tpu/ops/pallas/radix.py (``counting_sort``,
``counting_sort_by_tile``). The kernel is ``csrc/radix.cu`` (per pass a
digit histogram, its scan, and a stable scatter); its plain version is
:func:`counting_sort_plain`, a stable ``torch.sort`` and a gather. A stable
sort fixes its output completely, so the kernel equals the plain version bit
for bit, keys and payloads alike.

The JAX knobs ``chunk``, ``interpret`` and ``dma`` are TPU settings that
change no output; they are dropped. Unlike the Pallas version, which needs a
length with a power-of-two chunk of at least 128 lanes, any length works.
"""

import ctypes

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.ops.kernels.sort import MAX_PAYLOADS

TILE = 2048   # keys per block of csrc/radix.cu (THREADS * ITEMS)
RADIX = 64    # buckets of a full 6-bit pass


def counting_sort_plain(key, *vals, key_bound):
    """Plain PyTorch version of K8."""
    skey, order = torch.sort(key, stable=True)
    return (skey, *(v[order] for v in vals))


def counting_sort(key, *vals, key_bound):
    """Stable sort of (key, *vals) by key ascending; input order is the tie
    order. Keys must lie in [0, ``key_bound``); values are int32 or float32
    and move as bits. LSD over 6-bit digits: ceil(log64(key_bound)) passes,
    the last one exact. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if key.dtype != torch.int32 or key.dim() != 1 or not key.is_contiguous():
        raise ValueError(f"key must be contiguous int32 [m], got {key.dtype} {tuple(key.shape)}")
    if not 1 <= int(key_bound) <= 2**31 - 1:
        raise ValueError(f"key_bound must be in [1, 2**31 - 1], got {key_bound}")
    if len(vals) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payload columns, got {len(vals)}")
    for i, v in enumerate(vals):
        if (v.dtype not in (torch.int32, torch.float32) or tuple(v.shape) != tuple(key.shape)
                or not v.is_contiguous() or v.device != key.device):
            raise ValueError(f"value {i} must be contiguous int32 or float32 {list(key.shape)} "
                             f"on {key.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    if key.device.type == "cpu":
        return counting_sort_plain(key, *vals, key_bound=key_bound)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    m = key.shape[0]
    if m == 0:
        return (key.clone(), *(v.clone() for v in vals))
    n_blocks = -(-m // TILE)
    key_out = torch.empty_like(key)
    kbuf, ibuf0, ibuf1 = (torch.empty_like(key) for _ in range(3))
    counts = torch.empty(RADIX * n_blocks, dtype=torch.int32, device=key.device)
    outs = [torch.empty_like(v) for v in vals]
    ins_arr = (ctypes.c_void_p * MAX_PAYLOADS)(*(v.data_ptr() for v in vals))
    outs_arr = (ctypes.c_void_p * MAX_PAYLOADS)(*(o.data_ptr() for o in outs))
    _build.check(_build.library().egs_counting_sort(
        key.data_ptr(), key_out.data_ptr(), ins_arr, outs_arr, len(vals), kbuf.data_ptr(),
        ibuf0.data_ptr(), ibuf1.data_ptr(), counts.data_ptr(), m, int(key_bound), n_blocks,
        _build.stream_ptr(key)), "egs_counting_sort")
    counting_sort.launches += 1
    return (key_out, *outs)


counting_sort.launches = 0


def counting_sort_by_tile(tile, *vals, n_tiles):
    """Binning's entry point: tile values in [0, n_tiles], where n_tiles
    itself is the padding bucket."""
    return counting_sort(tile, *vals, key_bound=n_tiles + 1)
