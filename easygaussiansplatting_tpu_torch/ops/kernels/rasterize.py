"""K4 and K5: the stage-6 blend, forward and backward.

Port of ops/pallas/kernels.py ``forward_kernel`` and ``backward_kernel`` and
of ops/pallas/rasterize.py (``rasterize_pallas``, ``_raster_table_bwd``,
``_sort_reduce_grads``). The kernels are ``csrc/rasterize_fwd.cu`` and
``csrc/rasterize_bwd.cu``; their plain versions are ops/rasterize_tiled.py
with ops/blend.py. :class:`RasterizeFunction` joins them under autograd.

What ``rasterize_pallas`` does around its kernels is done by the CUDA
kernels themselves or is not needed: they gather table rows through
``patch_gsid`` (no packed per-patch array), fill empty tiles, and read and
write [3,H,W] / [H,W] directly (no [T,3,P] relayout). The chunk x tile
segment layout of the TPU grid (``binning.segment_layout``) has no
counterpart: a block per tile reads its own range.

The backward turns K5's per-patch gradients [9, M] into the table
cotangent [N, TABLE_COLS] by sort and segmented sum, as the JAX package does
on the TPU: a stable sort of the live patches' gaussian ids, a gather of the
rows by sorted position, K6 (``scan.segmented_cumsum``) with starts at key
changes, and a gather at each gaussian's segment end, read from the cumsum of
binning's ``gsid_counts``. Every sum runs in a fixed order, with no atomics,
so the gradients are the same on every run. By default the sort and the
gathers are library operations, as they are XLA operations in the JAX
package; the JAX package's opt-in routes sort with K7 or K8 instead
(:func:`sort_reduce_grads`).
"""

import ctypes

import torch

from easygaussiansplatting_tpu_torch.ops.binning import num_tiles
from easygaussiansplatting_tpu_torch.ops.kernels import _build, radix, scan, sort
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import LIVE_COLS, TABLE_COLS
from easygaussiansplatting_tpu_torch.ops.rasterize_tiled import (
    rasterize_tiled,
    rasterize_tiled_bwd,
)
from easygaussiansplatting_tpu_torch.utils.envflag import env_flag

INT32_MAX = 2**31 - 1


def rasterize_plain(table, patch_gsid, tile_start, tile_cnt, *, width, height):
    """Plain PyTorch version of K4 on the table layout. Returns
    (image [3,H,W], final_tau [H,W], contrib [H,W] int32)."""
    image, aux = rasterize_tiled(
        table[:, 0:2], table[:, 2:5], table[:, 5], table[:, 6:9],
        patch_gsid, tile_start, tile_cnt, width=width, height=height,
    )
    return image, aux["final_tau"], aux["contrib"]


def _check_inputs(table, patch_gsid, tile_start, tile_cnt, n_tiles):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != TABLE_COLS:
        raise ValueError(
            f"table must be float32 [N, {TABLE_COLS}], got {table.dtype} {tuple(table.shape)}")
    for name, t, size in (("patch_gsid", patch_gsid, None), ("tile_start", tile_start, n_tiles),
                          ("tile_cnt", tile_cnt, n_tiles)):
        if t.dtype != torch.int32 or t.dim() != 1 or (size is not None and t.shape[0] != size):
            raise ValueError(f"{name} must be int32 [{size or 'M'}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("table", table), ("patch_gsid", patch_gsid),
                    ("tile_start", tile_start), ("tile_cnt", tile_cnt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")


def rasterize_fwd(table, patch_gsid, tile_start, tile_cnt, *, width, height):
    """K4 wrapper: blend the binned table rows into (image [3,H,W],
    final_tau [H,W], contrib [H,W] int32), one 16x16 tile per block. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    gx, gy = num_tiles(width, height)
    _check_inputs(table, patch_gsid, tile_start, tile_cnt, gx * gy)
    if table.device.type == "cpu":
        return rasterize_plain(table, patch_gsid, tile_start, tile_cnt,
                               width=width, height=height)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    dev = table.device
    image = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_tau = torch.empty((height, width), dtype=torch.float32, device=dev)
    contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    _build.check(_build.library().egs_rasterize_fwd(
        table.data_ptr(), TABLE_COLS, patch_gsid.data_ptr(), tile_start.data_ptr(),
        tile_cnt.data_ptr(), gx, gy, width, height, image.data_ptr(),
        final_tau.data_ptr(), contrib.data_ptr(), _build.stream_ptr(table)),
        "egs_rasterize_fwd")
    rasterize_fwd.launches += 1
    return image, final_tau, contrib


rasterize_fwd.launches = 0



def rasterize_bwd_plain(table, patch_gsid, tile_start, tile_cnt, g_image, final_tau, contrib,
                        *, width, height):
    """Plain PyTorch version of K5 on the table layout: per-patch gradients
    [LIVE_COLS, M] (d ux, uy, conic a, b, c, alpha, r, g, b)."""
    return rasterize_tiled_bwd(
        table[:, 0:2], table[:, 2:5], table[:, 5], table[:, 6:9], patch_gsid, tile_start,
        tile_cnt, g_image, final_tau, contrib, width=width, height=height,
    )


def rasterize_bwd(table, patch_gsid, tile_start, tile_cnt, g_image, final_tau, contrib,
                  *, width, height):
    """K5 wrapper: the stage-6 backward from dL/dimage ``g_image`` [3,H,W]
    and the forward's ``final_tau`` [H,W] and ``contrib`` [H,W] int32 to the
    per-patch gradients [LIVE_COLS, M], zero on padding slots. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    gx, gy = num_tiles(width, height)
    _check_inputs(table, patch_gsid, tile_start, tile_cnt, gx * gy)
    for name, t, dtype, shape in (("g_image", g_image, torch.float32, (3, height, width)),
                                  ("final_tau", final_tau, torch.float32, (height, width)),
                                  ("contrib", contrib, torch.int32, (height, width))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
    if table.device.type == "cpu":
        return rasterize_bwd_plain(table, patch_gsid, tile_start, tile_cnt, g_image,
                                   final_tau, contrib, width=width, height=height)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    m = patch_gsid.shape[0]
    # slots no tile reaches (the padding tail, entries past every pixel's
    # contributor count) keep these zeros
    grads = torch.zeros((LIVE_COLS, m), dtype=torch.float32, device=table.device)
    _build.check(_build.library().egs_rasterize_bwd(
        table.data_ptr(), TABLE_COLS, patch_gsid.data_ptr(), tile_start.data_ptr(),
        tile_cnt.data_ptr(), gx, gy, width, height, g_image.data_ptr(), final_tau.data_ptr(),
        contrib.data_ptr(), grads.data_ptr(), m, _build.stream_ptr(table)),
        "egs_rasterize_bwd")
    rasterize_bwd.launches += 1
    return grads


rasterize_bwd.launches = 0


def kernel_info(kernel):
    """What the compiled K4 (``"fwd"``) or K5 (``"bwd"``) kernel takes on the
    card: {"registers": per thread, "blocks_per_sm": resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)}. Builds the kernels
    first if needed; needs the card."""
    if kernel not in ("fwd", "bwd"):
        raise ValueError(f"kernel must be 'fwd' or 'bwd', got {kernel!r}")
    out = (ctypes.c_int * 2)()
    _build.check(_build.library().egs_rasterize_info(("fwd", "bwd").index(kernel),
                                                     ctypes.addressof(out)),
                 "egs_rasterize_info")
    return dict(zip(("registers", "blocks_per_sm"), out))


def sort_reduce_grads(rows, patch_gsid, gsid_counts, use_kernels=True):
    """Per-patch gradient rows [R, M] -> per-gaussian sums [n, R] by sort and
    segmented sum (``_sort_reduce_grads`` of the JAX package).
    ``gsid_counts`` [n] are binning's per-gaussian patch counts.
    ``use_kernels=False`` takes the plain versions of K6, K7 and K8 on any
    device.

    The sort follows the JAX package's flags, read on each call: by default
    a stable library sort of (key, position) and a row gather;
    ``EGS_XLA_GRAD_SORT=0`` sorts (key, position) with K7;
    ``EGS_GRAD_PERM=0`` sorts the key with the R rows as K7's payload;
    ``EGS_RADIX_REDUCE=1`` sorts (key, position) with K8, dead patches in
    bucket n."""
    n = gsid_counts.shape[0]
    m = patch_gsid.shape[0]
    live = patch_gsid >= 0
    # dead and padding patches (gsid -1) key to INT32_MAX and sink to the
    # end; only live segments are read below.
    key = torch.where(live, patch_gsid, INT32_MAX)
    pairs = sort.sort_pairs if use_kernels else sort.sort_pairs_plain
    if env_flag("EGS_RADIX_REDUCE"):
        by_key = radix.counting_sort if use_kernels else radix.counting_sort_plain
        skey, pos = by_key(torch.where(live, patch_gsid, n), _positions(m, rows.device),
                           key_bound=n + 1)
        skey = torch.where(skey == n, INT32_MAX, skey)
        svals = rows.index_select(1, pos)
    elif env_flag("EGS_GRAD_PERM", default=True):
        if env_flag("EGS_XLA_GRAD_SORT", default=True):
            skey, pos = torch.sort(key, stable=True)
        else:
            skey, pos = pairs(key, _positions(m, rows.device))
        svals = rows.index_select(1, pos)
    else:
        skey, *cols = pairs(key, *rows.contiguous())
        svals = torch.stack(cols)
    flags = torch.ones(m, dtype=torch.int32, device=rows.device)
    flags[1:] = (skey[1:] != skey[:-1]).to(torch.int32)  # a segment starts at each id change
    cumsum = scan.segmented_cumsum if use_kernels else scan.segmented_cumsum_plain
    seg = cumsum(svals, flags)
    end = torch.clamp(torch.cumsum(gsid_counts, 0) - 1, 0, patch_gsid.shape[0] - 1)
    return torch.where((gsid_counts > 0)[:, None], seg.index_select(1, end).T, 0.0)


def _positions(m, device):
    return torch.arange(m, dtype=torch.int32, device=device)


class RasterizeFunction(torch.autograd.Function):
    """(image, final_tau, contrib) = K4(table rows by patch), with K5 and the
    sort-reduce as the backward of ``image`` into the table. ``final_tau``
    and ``contrib`` take no gradient. ``use_kernels=False`` runs the plain
    versions on any device (the all-plain path)."""

    @staticmethod
    def forward(ctx, table, patch_gsid, tile_start, tile_cnt, gsid_counts, width, height,
                use_kernels):
        fwd = rasterize_fwd if use_kernels else rasterize_plain
        image, final_tau, contrib = fwd(table, patch_gsid, tile_start, tile_cnt,
                                        width=width, height=height)
        ctx.save_for_backward(table, patch_gsid, tile_start, tile_cnt, gsid_counts,
                              final_tau, contrib)
        ctx.dims = (width, height, use_kernels)
        ctx.mark_non_differentiable(final_tau, contrib)
        return image, final_tau, contrib

    @staticmethod
    def backward(ctx, g_image, _g_tau, _g_contrib):
        table, patch_gsid, tile_start, tile_cnt, gsid_counts, final_tau, contrib = (
            ctx.saved_tensors)
        width, height, use_kernels = ctx.dims
        bwd = rasterize_bwd if use_kernels else rasterize_bwd_plain
        rows = bwd(table, patch_gsid, tile_start, tile_cnt, g_image.contiguous(), final_tau,
                   contrib, width=width, height=height)
        dtable = sort_reduce_grads(rows, patch_gsid, gsid_counts, use_kernels)
        dtable = torch.nn.functional.pad(dtable, (0, TABLE_COLS - LIVE_COLS))
        return dtable, None, None, None, None, None, None, None
