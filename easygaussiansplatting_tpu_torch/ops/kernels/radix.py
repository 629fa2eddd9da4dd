"""K8: stable LSD radix sort of bounded int32 keys.

Port of easygaussiansplatting_tpu/ops/pallas/radix.py (``counting_sort``,
``counting_sort_by_tile``). The kernel is ``csrc/radix.cu``; its plain
version is :func:`counting_sort_plain`, a stable ``torch.sort`` and a
gather. A stable sort fixes its output completely, so the kernel equals the
plain version bit for bit, keys and payloads alike.

On an H100 the sort is bound by bytes, and launches and idle SMs are what
cost: the kernel counts the digits of every pass in one upfront launch, then
runs one single-sweep scatter per 8-bit pass (tiles of 4,096 keys ranked
stably in shared memory, global offsets by decoupled look-back over
flagged words, each digit's run written contiguously), then one gather of
the payload columns: passes + 2 launches. The kernel library owns that
plan: :func:`kernel_plan` asks it for a call's passes and the scratch the
wrapper allocates (uninitialised: the launches zero what they need).

The JAX knobs ``chunk``, ``interpret`` and ``dma`` are TPU settings that
change no output; they are dropped. Unlike the Pallas version, which needs a
length with a power-of-two chunk of at least 128 lanes, any length below
2^30 works.
"""

import ctypes

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.ops.kernels.sort import MAX_PAYLOADS, check_length

def kernel_plan(m, key_bound):
    """csrc/radix.cu's plan for a call on m keys in [0, ``key_bound``): (its
    8-bit passes, int32 words of scratch). Asks the kernel library, so it
    needs the CUDA toolkit."""
    passes, words = ctypes.c_longlong(), ctypes.c_longlong()
    _build.check(_build.library().egs_counting_sort_plan(
        m, int(key_bound), ctypes.byref(passes), ctypes.byref(words)), "egs_counting_sort_plan")
    return passes.value, words.value


def counting_sort_plain(key, *vals, key_bound):
    """Plain PyTorch version of K8."""
    skey, order = torch.sort(key, stable=True)
    return (skey, *(v[order] for v in vals))


def counting_sort(key, *vals, key_bound):
    """Stable sort of (key, *vals) by key ascending; input order is the tie
    order. Keys must lie in [0, ``key_bound``); values are int32 or float32
    and move as bits; fewer than 2^30 of them. LSD over 8-bit digits:
    ceil(log256(key_bound)) passes (at least one), the last one exact. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
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
    check_length(key.shape[0])
    if key.device.type == "cpu":
        return counting_sort_plain(key, *vals, key_bound=key_bound)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    m = key.shape[0]
    if m == 0:
        return (key.clone(), *(v.clone() for v in vals))
    key_out = torch.empty_like(key)
    scratch = torch.empty(kernel_plan(m, key_bound)[1], dtype=torch.int32, device=key.device)
    outs = [torch.empty_like(v) for v in vals]
    ins_arr = (ctypes.c_void_p * MAX_PAYLOADS)(*(v.data_ptr() for v in vals))
    outs_arr = (ctypes.c_void_p * MAX_PAYLOADS)(*(o.data_ptr() for o in outs))
    _build.check(_build.library().egs_counting_sort(
        key.data_ptr(), key_out.data_ptr(), ins_arr, outs_arr, len(vals), scratch.data_ptr(),
        scratch.numel(), m, int(key_bound), _build.stream_ptr(key)), "egs_counting_sort")
    counting_sort.launches += 1
    return (key_out, *outs)


counting_sort.launches = 0


def counting_sort_by_tile(tile, *vals, n_tiles):
    """Binning's entry point: tile values in [0, n_tiles], where n_tiles
    itself is the padding bucket."""
    return counting_sort(tile, *vals, key_bound=n_tiles + 1)
