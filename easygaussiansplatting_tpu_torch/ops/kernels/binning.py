"""K12: tile binning whose work follows the view (``csrc/binning.cu``).

Builds the draw lists of ``ops/binning.py::bin_gaussians`` from the
gaussians and the patches they cover: a prep kernel (depth keys, tile rects,
skip radii), the stable depth sort (``torch.sort``), a count kernel, K3
over the two N-long count rows, an emit kernel that writes each kept patch
once in depth order, a per-chunk tile count, K3 over that [n_tiles,
n_chunks] matrix, and a placement that moves each patch to its tile's list
in depth order and fills the padding. No array the size of the slot budget
is scattered, gathered or sorted, and nothing is read back to the host.

K12 replaces no Pallas kernel (the JAX package bins with XLA ops, which XLA
fuses); its plain version is the slot path of ``ops/binning.py``
(``bin_gaussians(..., use_kernels=False)``), whose outputs it equals bit for
bit. Unlike the other wrappers it has no CPU route: ``bin_gaussians`` calls
it for CUDA tensors only, and it raises on any other device, on inputs that
are not float32 and on a budget past int32 slot positions. It takes any
tile count: a view of more tiles than a warp's counters hold in shared
memory is counted and placed in bands of tiles. The kernel library owns the
plan (:func:`kernel_plan`), asked for once a call.
"""

import ctypes

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build, scan

# the scalars' order in the kernel's [5] output (csrc/binning.cu)
SCALARS = ("total", "n_dropped", "total_rows", "rows_dropped")
N_SCALARS = 5
PLAN = ("chunk", "chunks", "band", "bands", "warps", "smem", "cells")


def kernel_plan(n_tiles, max_patches):
    """csrc/binning.cu's plan for a view of ``n_tiles`` tiles at a budget of
    ``max_patches`` slots: {"chunk": slots a warp, "chunks", "band": tiles a
    warp counts, "bands", "warps": a block, "smem": dynamic shared bytes a
    block, "cells": n_tiles * chunks}, or None where K12 cannot take the
    budget (below 1 slot or past int32 positions) or there is no tile. Asks
    the kernel library, so it needs the CUDA toolkit."""
    out = (ctypes.c_longlong * len(PLAN))()
    if _build.library().egs_bin_plan(int(n_tiles), int(max_patches), out) != 0:
        return None
    return dict(zip(PLAN, out))


def _column(t, n, cols=None):
    """Pointer and row stride of a float32 [n] or [n, cols] tensor whose
    columns are contiguous (the K1 table's column views are)."""
    shape = (n,) if cols is None else (n, cols)
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or (cols is not None and t.stride(1) != 1)):
        raise ValueError(f"expected float32 {list(shape)} with unit column stride, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.data_ptr(), t.stride(0)


def prep(us, depths, areas, valid, *, cinv2ds=None, alphas=None, gx, gy):
    """K12's first kernel: each gaussian's depth key (its depth's int32
    bits, +inf's where invalid or below ALPHA_SKIP), rect [N, 4] int32 and
    validity (``gaussian_rects``) and skip radius^2 [N] float32
    (``skip_radius2``, +inf without conics), from float32 ``us`` [N, 2],
    ``depths`` [N], ``areas`` [N, 2] and ``alphas`` [N] (any row stride) and
    bool ``valid`` [N]. CUDA tensors only."""
    dev = us.device
    if dev.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors only, got {dev}; the slot path of "
                         "ops/binning.py is its plain version")
    n = us.shape[0]
    if n < 1:
        raise ValueError("K12 needs at least one gaussian")
    if cinv2ds is not None and alphas is None:
        raise ValueError("ellipse row culling needs alphas beside cinv2ds")
    if any(t is not None and t.device != dev for t in (depths, areas, valid, cinv2ds, alphas)):
        raise ValueError(f"every input must be on {dev}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        raise ValueError(f"valid must be bool [{n}], got {valid.dtype} {tuple(valid.shape)}")
    us_p, us_s = _column(us, n, 2)
    ar_p, ar_s = _column(areas, n, 2)
    d_p, d_s = _column(depths, n)
    al_p, al_s = _column(alphas, n) if alphas is not None else (None, 0)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    rects = torch.empty((n, 4), dtype=torch.int32, device=dev)
    valid_r = torch.empty(n, dtype=torch.bool, device=dev)
    r2 = torch.empty(n, dtype=torch.float32, device=dev)
    _build.check(_build.library().egs_bin_prep(
        us_p, us_s, ar_p, ar_s, d_p, d_s, valid.contiguous().data_ptr(), al_p, al_s,
        int(cinv2ds is not None), n, gx, gy, keys.data_ptr(), rects.data_ptr(),
        valid_r.data_ptr(), r2.data_ptr(), _build.stream_ptr(us)), "egs_bin_prep")
    return keys, rects, valid_r, r2


def bin_lists(us, depths, areas, valid, *, cinv2ds=None, alphas=None, gx, gy, max_patches,
              max_rows, gsid_counts=False):
    """``bin_gaussians``'s draw lists from its inputs (those of :func:`prep`
    and ``cinv2ds`` [N, 3]) for a view of gx x gy tiles. Returns the dict of
    ``bin_gaussians``. CUDA tensors only: four launches of K12 (five device
    kernels), one ``torch.sort`` and two K3 calls."""
    keys, rects, valid_r, r2 = prep(us, depths, areas, valid, cinv2ds=cinv2ds, alphas=alphas,
                                    gx=gx, gy=gy)
    n_tiles = gx * gy
    plan = kernel_plan(n_tiles, max_patches)
    if plan is None:
        raise ValueError(f"K12 takes budgets of 1 to 2^31 - 1 slots and a view of a tile or "
                         f"more, got {max_patches} slots and {n_tiles} tiles")
    bands = (plan["chunk"], plan["chunks"], plan["band"], plan["bands"])
    # the stable depth sort (invalid gaussians, keyed +inf, to the back), as
    # the slot path sorts
    order = torch.sort(keys, stable=True).indices
    n = us.shape[0]
    us_p, us_s = _column(us, n, 2)
    c_p, c_s = _column(cinv2ds, n, 3) if cinv2ds is not None else (None, 0)
    max_rows = min(int(max_rows), 2**31 - 1)  # a C int; row counts are int32 sums
    lib = _build.library()
    stream = _build.stream_ptr(us)
    i32 = dict(dtype=torch.int32, device=us.device)

    counts = torch.empty((2, n), **i32)
    _build.check(lib.egs_bin_count(
        order.data_ptr(), rects.data_ptr(), valid_r.data_ptr(), us_p, us_s, c_p, c_s,
        r2.data_ptr(), n, counts.data_ptr(), stream), "egs_bin_count")
    cums = scan.multi_cumsum(counts)

    scalars = torch.empty(N_SCALARS, **i32)
    slots = torch.empty((2, max_patches), **i32)  # depth-major tile ids and gaussian ids
    hist = torch.empty((1, plan["cells"]), **i32)
    counts_out = torch.empty(n, **i32) if gsid_counts else None
    _build.check(lib.egs_bin_emit(
        order.data_ptr(), rects.data_ptr(), us_p, us_s, c_p, c_s, r2.data_ptr(), n, gx, n_tiles,
        counts.data_ptr(), cums.data_ptr(), max_rows, max_patches, scalars.data_ptr(),
        slots[0].data_ptr(), slots[1].data_ptr(),
        counts_out.data_ptr() if gsid_counts else None, hist.data_ptr(), *bands, stream),
        "egs_bin_emit")
    sums = scan.multi_cumsum(hist)

    patch_gsid = torch.empty(max_patches, **i32)
    patch_tile = torch.empty(max_patches, **i32)
    ranges = torch.empty((2, n_tiles), **i32)
    _build.check(lib.egs_bin_place(
        slots[0].data_ptr(), slots[1].data_ptr(), hist.data_ptr(), sums.data_ptr(),
        scalars.data_ptr(), n_tiles, max_patches, patch_gsid.data_ptr(), patch_tile.data_ptr(),
        ranges[0].data_ptr(), ranges[1].data_ptr(), *bands, stream), "egs_bin_place")
    bin_lists.launches += 1

    out = {"patch_gsid": patch_gsid, "patch_tile": patch_tile, "tile_start": ranges[0],
           "tile_cnt": ranges[1], **{k: scalars[i] for i, k in enumerate(SCALARS)}}
    if gsid_counts:
        out["gsid_counts"] = counts_out
    return out


bin_lists.launches = 0
