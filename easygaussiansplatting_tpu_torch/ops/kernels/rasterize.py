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
counterpart: a block per tile reads its own range in K5, and in K4 where
the frame's tiles fill the card. Where they do not (a 160x120 preview has 80
tiles), K4 cuts each list into chunks, walked by the card's resident CTAs
and combined front to back (:func:`fwd_plan`, csrc/rasterize_fwd.cu).

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
import functools

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

# K4's chunk length. A frame with fewer tiles than half the card's resident
# K4 CTAs cuts its lists into chunks of L entries, so that the first wave of
# resident CTAs covers every tile to about WAVE_DEPTH entries; L is a
# multiple of CHUNK_ALIGN, at least MIN_CHUNK. On an H100 K4 holds 1,584
# chunk CTAs, 19 a tile of a 160x120 preview, whose deepest pixel walks run
# to ~10k entries on a truck-sized scene; there L from 192 to 256 timed best
# (0.307-0.317 ms against 0.33-0.44 at 128 and 384-512,
# probes/k4_views.py --chunks): WAVE_DEPTH 4096 gives 224. Walks deeper than
# the first wave reaches take chunks of the later waves.
WAVE_DEPTH = 4096
CHUNK_ALIGN = 32
MIN_CHUNK = 64
# K4's counters, the first words of its state
COUNTERS = ("blend.items", "blend.items_skipped", "blend.rewalked")


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


def chunk_length(n_tiles, resident):
    """K4's chunk length L for a frame of ``n_tiles`` tiles on a card that
    holds ``resident`` of its CTAs at once: 0 (a CTA a tile, the whole list)
    where fewer than two CTAs a tile fit, else WAVE_DEPTH over the CTAs a
    tile, rounded up to CHUNK_ALIGN, at least MIN_CHUNK (at most WAVE_DEPTH
    / 2, within the kernel's bound)."""
    per_tile = resident // max(1, n_tiles)
    if per_tile < 2:
        return 0
    length = -(-WAVE_DEPTH // per_tile)
    return max(MIN_CHUNK, -(-length // CHUNK_ALIGN) * CHUNK_ALIGN)


PLAN = ("grid", "state_words", "slot_floats")


def fwd_plan(n_tiles, resident, chunk=None):
    """K4's launch for ``n_tiles`` tiles on a card that holds ``resident``
    chunk CTAs (``chunk``: L, by default :func:`chunk_length`): {"chunk",
    "grid": CTAs, "state_words": int32 words of state, "slot_floats":
    float32s of slots}, the last two 0 for a CTA a tile. Asks the kernel
    library (csrc/rasterize_fwd.cu), so it needs the CUDA toolkit; raises
    ValueError on a chunk past the kernel's bound."""
    if chunk is None:
        chunk = chunk_length(n_tiles, resident)
    out = (ctypes.c_longlong * len(PLAN))()
    if _build.library().egs_rasterize_fwd_plan(int(n_tiles), int(chunk), int(resident),
                                                out) != 0:
        raise ValueError(f"K4 takes no chunk of {chunk} entries ({n_tiles} tiles, "
                         f"{resident} resident CTAs)")
    return {"chunk": chunk, **dict(zip(PLAN, out))}


@functools.lru_cache(maxsize=None)
def resident_ctas(device):
    """CTAs of chunked K4 the card ``device`` (a CUDA torch.device) holds at
    once: its blocks an SM times the SMs. Asked once a device."""
    with torch.cuda.device(device):
        per_sm = kernel_info("fwd_split")["blocks_per_sm"]
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def rasterize_fwd(table, patch_gsid, tile_start, tile_cnt, *, width, height, counters=None):
    """K4 wrapper: blend the binned table rows into (image [3,H,W],
    final_tau [H,W], contrib [H,W] int32), one 16x16 tile per block, or,
    where the frame's tiles do not fill the card, chunks of each tile's list
    per block (:func:`fwd_plan`). CPU tensors take the plain version; CUDA
    tensors launch the kernel. A ``counters`` dict receives the call's
    COUNTERS as 0-d int32 tensors, without a synchronise: items walked (a
    tile, or a chunk of one), items left on a tile that ended before them,
    pixels walked again over the chunk their stop falls in. In chunks the
    kernel counts them in its state, on the device; a CTA a tile, as the
    plain version, walks every tile as one item (:func:`plain_counters`)."""
    gx, gy = num_tiles(width, height)
    _check_inputs(table, patch_gsid, tile_start, tile_cnt, gx * gy)
    if table.device.type == "cpu":
        if counters is not None:
            counters.update(plain_counters(gx * gy))
        return rasterize_plain(table, patch_gsid, tile_start, tile_cnt,
                               width=width, height=height)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    plan = fwd_plan(gx * gy, resident_ctas(table.device))
    image, final_tau, contrib, state = launch_fwd(table, patch_gsid, tile_start, tile_cnt,
                                                  plan, width=width, height=height)
    if counters is not None:
        counters.update(plain_counters(gx * gy) if state is None
                        else zip(COUNTERS, state[:len(COUNTERS)]))
    return image, final_tau, contrib


def plain_counters(n_tiles):
    """K4's COUNTERS for the plain version, which walks each of the
    ``n_tiles`` tiles as one item, as K4 a CTA a tile does: {name: 0-d
    int32 tensor}."""
    return dict(zip(COUNTERS, torch.tensor([n_tiles, 0, 0], dtype=torch.int32)))


def launch_fwd(table, patch_gsid, tile_start, tile_cnt, plan, *, width, height):
    """Launch K4 on CUDA tensors with a :func:`fwd_plan`; returns (image,
    final_tau, contrib, state: int32 [state_words] or None). Counts the
    launch in ``rasterize_fwd.launches``."""
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    gx, gy = num_tiles(width, height)
    dev = table.device
    image = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_tau = torch.empty((height, width), dtype=torch.float32, device=dev)
    contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    state = (torch.empty(plan["state_words"], dtype=torch.int32, device=dev)
             if plan["state_words"] else None)
    slots = (torch.empty(plan["slot_floats"], dtype=torch.float32, device=dev)
             if plan["slot_floats"] else None)
    _build.check(_build.library().egs_rasterize_fwd(
        table.data_ptr(), TABLE_COLS, patch_gsid.data_ptr(), tile_start.data_ptr(),
        tile_cnt.data_ptr(), gx, gy, width, height, plan["chunk"], plan["grid"],
        image.data_ptr(), final_tau.data_ptr(), contrib.data_ptr(),
        None if state is None else state.data_ptr(), plan["state_words"],
        None if slots is None else slots.data_ptr(), _build.stream_ptr(table)),
        "egs_rasterize_fwd")
    rasterize_fwd.launches += 1
    return image, final_tau, contrib, state


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


KERNELS = ("fwd", "bwd", "fwd_split")


def kernel_info(kernel):
    """What the compiled K4 (``"fwd"``: a CTA a tile; ``"fwd_split"``:
    chunks) or K5 (``"bwd"``) kernel takes on the card: {"registers": per
    thread, "blocks_per_sm": resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)}. Builds the kernels
    first if needed; needs the card."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    out = (ctypes.c_int * 2)()
    _build.check(_build.library().egs_rasterize_info(KERNELS.index(kernel),
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
    versions on any device (the all-plain path). A ``counters`` dict
    receives K4's counters (:func:`rasterize_fwd`)."""

    @staticmethod
    def forward(ctx, table, patch_gsid, tile_start, tile_cnt, gsid_counts, width, height,
                use_kernels, counters=None):
        if use_kernels:
            image, final_tau, contrib = rasterize_fwd(table, patch_gsid, tile_start, tile_cnt,
                                                      width=width, height=height,
                                                      counters=counters)
        else:
            image, final_tau, contrib = rasterize_plain(table, patch_gsid, tile_start,
                                                        tile_cnt, width=width, height=height)
            if counters is not None:
                counters.update(plain_counters(tile_cnt.numel()))
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
        return dtable, None, None, None, None, None, None, None, None
