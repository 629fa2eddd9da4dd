"""K7: stable merge sort by int32 keys, carrying payload columns.

Port of easygaussiansplatting_tpu/ops/pallas/sort.py (``sort_pairs``,
``sort_blocks``). The kernel is ``csrc/sort.cu``; its plain versions are
:func:`sort_pairs_plain` and :func:`sort_blocks_plain`, a stable
``torch.sort`` on the key (two key words as one int64 composite) and a
gather of every array.

The TPU kernel is a bitonic network padded to a power of two. On an H100 the
bound is bytes, and a network pays log2(m)^2 / 2 passes over them, one launch
per global stage; so the kernel is a merge sort on exactly m entries
instead: a CTA sorts each tile of 4,096 entries (registers, then merges in
shared memory), then one pass per doubling of the run width merges pairs of
runs, 4,096 outputs per CTA split by a merge-path search, and one gather
moves the payload columns by the final source index. Merges take from the
left run on ties, so the result is stable and equals the plain version
exactly. The kernel library owns the plan: :func:`kernel_plan` asks it for
a call's merge levels and scratch.

The JAX knobs ``block`` (of ``sort_pairs``), ``group``, ``interpret`` and
``n_live`` are TPU VMEM and grid settings that change no output; they are
dropped. ``n_keys`` is 1 or 2 (the only uses). Keys are int32; payloads are
int32 or float32 and move as bits. Lengths are below :data:`MAX_LENGTH`.

Order of equal keys: the JAX network is not stable and leaves it
unspecified. The CUDA kernel and its plain version return the stable order;
tests that hold either to the JAX package compare keys exactly and (key,
payload) pairs as multisets.
"""

import ctypes

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build

INT32_MAX = 2**31 - 1
MAX_PAYLOADS = 16  # columns.cuh MAX_COLUMNS
MAX_LENGTH = 2**30  # lengths below it (both sorts; K8's look-back words hold 30-bit counts)
_WORDS = (torch.int32, torch.float32)


def check_length(m):
    if m >= MAX_LENGTH:
        raise ValueError(f"length {m} must be below 2**30")


def kernel_plan(m, n_keys=1, block=0):
    """csrc/sort.cu's plan for a call on m entries (``block`` 0: one run of
    everything): (merge levels after the CTA sort, int32 words of scratch).
    Asks the kernel library, so it needs the CUDA toolkit."""
    levels, words = ctypes.c_longlong(), ctypes.c_longlong()
    _build.check(_build.library().egs_sort_plan(m, block, n_keys, ctypes.byref(levels),
                                                ctypes.byref(words)), "egs_sort_plan")
    return levels.value, words.value


def _check(keys, vals, n_keys):
    if n_keys not in (1, 2):
        raise ValueError(f"n_keys must be 1 or 2, got {n_keys}")
    if len(vals) < n_keys - 1:
        raise ValueError(f"n_keys={n_keys} needs {n_keys - 1} key word(s) among the values")
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"keys must be int32 [m], got {keys.dtype} {tuple(keys.shape)}")
    check_length(keys.shape[0])
    if n_keys == 2 and vals[0].dtype != torch.int32:
        raise ValueError(f"the second key word must be int32, got {vals[0].dtype}")
    if len(vals) - (n_keys - 1) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payload columns, got {len(vals)}")
    for i, v in enumerate(vals):
        if v.dtype not in _WORDS or tuple(v.shape) != tuple(keys.shape):
            raise ValueError(f"value {i} must be int32 or float32 {list(keys.shape)}, got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != keys.device:
            raise ValueError(f"value {i} is on {v.device}, keys on {keys.device}")
    if not all(a.is_contiguous() for a in (keys, *vals)):
        raise ValueError("sort takes contiguous tensors")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")


def _order(keys, vals, n_keys):
    """Stable ascending order of the (one- or two-word) keys, along the last
    axis."""
    if n_keys == 1:
        return torch.sort(keys, dim=-1, stable=True).indices
    comp = (keys.long() << 32) + (vals[0].long() + 2**31)
    return torch.sort(comp, dim=-1, stable=True).indices


def sort_pairs_plain(keys, *vals, n_keys=1, pad_key=None):
    """Plain PyTorch version of K7's ``sort_pairs``: [keys, *vals] sorted by
    the first ``n_keys`` arrays. ``pad_key`` has nothing to pad here."""
    order = _order(keys, vals, n_keys)
    return [a[order] for a in (keys, *vals)]


def sort_blocks_plain(keys, *vals, block, n_keys=1):
    """Plain PyTorch version of K7's ``sort_blocks``."""
    rows = [a.reshape(-1, block) for a in (keys, *vals)]
    order = _order(rows[0], rows[1:], n_keys)
    return [torch.gather(a, 1, order).reshape(-1) for a in rows]


def _launch(keys, vals, n_keys, block):
    """Run csrc/sort.cu; returns [sorted key words..., sorted payloads...]."""
    m = keys.shape[0]
    words = [torch.empty_like(keys) for _ in range(n_keys)]
    scratch = torch.empty(kernel_plan(m, n_keys, block)[1], dtype=torch.int32,
                          device=keys.device)
    payload = vals[n_keys - 1:]
    outs = [torch.empty_like(v) for v in payload]
    ins_arr = (ctypes.c_void_p * MAX_PAYLOADS)(*(v.data_ptr() for v in payload))
    outs_arr = (ctypes.c_void_p * MAX_PAYLOADS)(*(o.data_ptr() for o in outs))
    _build.check(_build.library().egs_sort(
        keys.data_ptr(), vals[0].data_ptr() if n_keys == 2 else None, n_keys,
        ins_arr, outs_arr, len(payload), words[0].data_ptr(),
        words[1].data_ptr() if n_keys == 2 else None, scratch.data_ptr(), scratch.numel(), m,
        block, _build.stream_ptr(keys)), "egs_sort")
    return words + outs


def sort_pairs(keys, *vals, n_keys=1, pad_key=None):
    """Sort by int32 ``keys`` ascending, carrying any number of int32/float32
    payload columns; with ``n_keys=2`` the first value is a second key word,
    compared after ``keys``. Returns [keys, *vals] sorted, stably.

    ``pad_key`` stays for parity with the JAX signature, whose network pads
    to a power of two with it; the merge sort pads nothing, so it has
    nothing to do. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _check(keys, vals, n_keys)
    if keys.device.type == "cpu":
        return sort_pairs_plain(keys, *vals, n_keys=n_keys)
    if keys.shape[0] == 0:
        return [a.clone() for a in (keys, *vals)]
    out = _launch(keys, vals, n_keys, 0)
    sort_pairs.launches += 1
    return out


sort_pairs.launches = 0


def sort_blocks(keys, *vals, block, n_keys=1):
    """Sort each consecutive ``block``-element slice on its own (ascending by
    the first ``n_keys`` arrays, lexicographically and stably; the other
    arrays ride as payload). ``block`` must be a power of two, at least 128,
    that divides the length. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(keys, vals, n_keys)
    m = keys.shape[0]
    if block & (block - 1) or block < 128 or m % block:
        raise ValueError(f"block {block} must be a power of two >= 128 dividing m={m}")
    if keys.device.type == "cpu":
        return sort_blocks_plain(keys, *vals, block=block, n_keys=n_keys)
    if m == 0:
        return [a.clone() for a in (keys, *vals)]
    out = _launch(keys, vals, n_keys, block)
    sort_blocks.launches += 1
    return out


sort_blocks.launches = 0
