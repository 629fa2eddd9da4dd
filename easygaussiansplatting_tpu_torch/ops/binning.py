"""Tile binning: fixed-capacity, sort-based, with no host round-trip.

Port of easygaussiansplatting_tpu/ops/binning.py (``num_tiles``,
``gaussian_rects``, ``_propagate_marks``, ``bin_gaussians`` with ellipse row
culling, ``dense_tile_lists``). The integer outputs equal the JAX ones
exactly, on either of two routes.

**K12** (ops/kernels/binning.py, ``csrc/binning.cu``): CUDA tensors on the
kernel route (``use_kernels=True``) with none of the opt-in sort flags below
set, at any view size; it computes in float32 and raises on other inputs. Its work follows the gaussians and the patches the view
covers: one kernel prepares each gaussian (its depth key, ``gaussian_rects``,
the skip-ellipse radius^2), the stable depth sort stays ``torch.sort``, and
then per-gaussian row and patch counts, K3 over them, each kept patch
written once in depth order, and a stable placement by tile through
per-chunk tile counts. Every render of the ``cuda`` backend takes it: the
viewer, the headless turntable, the training monitor, ``render.py`` and
``eval.py``, the train step (with ``gsid_counts``) and the banded and
sharded steps of ``parallel/``.

**The slot path**: every other call, i.e. CPU tensors, ``use_kernels=False``
(the plain version, held to JAX on the CPU and K12's yardstick on the card)
and the opt-in sort routes. It expands into arrays of
``max_rows`` and ``max_patches`` slots as the JAX package does, with these
changes:

* the cumulative sums of the row and patch expansion go through the K3
  wrapper (ops/kernels/scan.py), as the JAX binning's go through its Pallas
  scan; ``use_kernels=False`` takes K3's plain version instead;
* ``_propagate_marks`` scatters with ``index_add_``, which has no drop mode:
  starts at or past the budget are masked to a zero add first;
* per-tile counts are a count (an ``index_add_`` of ones) of the slot tile
  ids below ``n_tiles``, and the starts their exclusive cumsum. The JAX
  compare-reduce over a [n_tiles, max_rows] mask (~5e8 elements at the
  bench budgets) is fused by XLA but would be allocated by eager PyTorch;
  the count equals it, drop-deepest truncation included, since exactly the
  slots below the kept count carry a tile id below ``n_tiles``;
* the (tile, slot) key packing becomes a stable sort on the tile id: the
  slots are already in (depth, row, tile) order;
* ``gsid_counts`` inverts the depth permutation with an index write (the
  JAX package sorts (order, counts) pairs): ``order`` is a permutation, so
  the indices are unique.

The JAX package's opt-in sort routes are read from the same flags at the
same places, on each call, and take the slot path: ``EGS_RADIX_SORT=1``
sorts by tile with K8 (ops/kernels/radix.py) on every backend;
``EGS_LEX_SORT=1`` sorts the two-word (tile, slot) key with K7
(ops/kernels/sort.py) where the packed key would overflow 32 bits, on the
kernel backend (the JAX package: on the TPU); ``EGS_XLA_GRAD_SORT=0``
inverts ``gsid_counts`` by K7, on the kernel backend. With
``use_kernels=False`` the radix route runs K8's plain version and the two K7
routes are not taken. Every route's integer outputs equal the default
route's.

Overflow policy: if the patch count exceeds ``max_patches`` (or the row count
``max_rows``), the patches of the *deepest* Gaussians are dropped and
``n_dropped`` / ``rows_dropped`` report the loss.
"""

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import binning as kernel_binning
from easygaussiansplatting_tpu_torch.ops.kernels import radix, scan, sort
from easygaussiansplatting_tpu_torch.utils.envflag import env_flag

TILE = 16  # pixels per tile edge
ALPHA_SKIP = 0.002  # blend skip threshold (ops/blend.py)


def num_tiles(width, height, tile=TILE):
    gx = -(-width // tile)
    gy = -(-height // tile)
    return gx, gy


def gaussian_rects(us, areas, valid, width, height, tile=TILE):
    """Tile-space rects [N,4] int32 (x0, y0, x1, y1) and updated validity."""
    gx, gy = num_tiles(width, height, tile)
    ftile = _scalar(tile, us)

    def edge(v, rnd, hi):
        return torch.clamp(rnd(v / ftile), 0, hi).to(torch.int32)

    x0 = edge(us[:, 0] - areas[:, 0], torch.floor, gx)
    y0 = edge(us[:, 1] - areas[:, 1], torch.floor, gy)
    x1 = edge(us[:, 0] + areas[:, 0], torch.ceil, gx)
    y1 = edge(us[:, 1] + areas[:, 1], torch.ceil, gy)
    n = (x1 - x0) * (y1 - y0)
    valid = valid & (n > 0)
    return torch.stack([x0, y0, x1, y1], dim=1), valid


def _scalar(v, like):
    """A 0-d device tensor: dividing by it is a true division on every device
    (CUDA multiplies by the reciprocal of a Python scalar divisor), and it is
    filled on the device, with no host-to-device copy."""
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def _propagate_marks(starts, values, budget):
    """Scatter the segment-value deltas at the segment starts; the caller
    integrates with a cumsum. Starts at or past ``budget`` are dropped."""
    deltas = torch.diff(values, prepend=values.new_zeros(1))
    keep = starts < budget
    idx = torch.where(keep, starts, 0).long()
    return torch.zeros(budget, dtype=values.dtype, device=values.device).index_add_(
        0, idx, torch.where(keep, deltas, 0))


def bin_gaussians(us, depths, areas, valid, *, width, height, max_patches,
                  max_rows=None, cinv2ds=None, alphas=None, gsid_counts=False,
                  use_kernels=True):
    """Build the per-tile draw lists (see the JAX ``bin_gaussians``).

    Pass ``cinv2ds`` [N,3] conics + ``alphas`` [N] for ellipse row culling:
    each tile-row's x-extent is clipped to the alpha' >= ALPHA_SKIP ellipse
    intersected with the 3-sigma AABB (pixel-exact against the AABB
    candidate set), and alpha < ALPHA_SKIP gaussians are culled outright.

    Returns dict of int32 tensors:
      patch_gsid  [max_patches] — gaussian index per patch, sorted by
                  (tile, depth); padding slots hold -1.
      patch_tile  [max_patches] — tile id per patch (n_tiles on padding).
      tile_start  [T], tile_cnt [T] — per-tile ranges.
      total       — patch count after ellipse culling, before the cap.
      n_dropped   — patches beyond the patch budget.
      total_rows  — AABB-covered tile-rows.
      rows_dropped — tile-rows beyond the row budget.
      gsid_counts [N] — with ``gsid_counts=True`` only: each gaussian's
                  kept patch count, in gaussian id order (the backward's
                  gradient reduce reads segment ends from its cumsum).
    and ``kernel``, a bool: True where K12 built the lists, False where the
    slot path did (the module docstring says which calls take which).
    """
    if max_rows is None:
        max_rows = max_patches
    gx, gy = num_tiles(width, height)
    n_tiles = gx * gy
    if takes_kernel(us, use_kernels):
        out = kernel_binning.bin_lists(
            us, depths, areas, valid, cinv2ds=cinv2ds, alphas=alphas, gx=gx, gy=gy,
            max_patches=max_patches, max_rows=max_rows, gsid_counts=gsid_counts)
        return {**out, "kernel": True}

    # The slot path.
    cumsum = scan.multi_cumsum if use_kernels else scan.multi_cumsum_plain
    n = us.shape[0]
    dev = us.device
    f = torch.float64 if us.dtype == torch.float64 else torch.float32
    i32 = torch.int32

    if alphas is not None:
        valid = valid & (alphas >= ALPHA_SKIP)

    # Depth-sort the gaussians (invalid ones to the back) on the int bit
    # patterns of the positive depths, stably as lax.sort_key_val does.
    fkeys = torch.where(valid, depths, torch.inf)
    keys = fkeys.contiguous().view(torch.int64 if fkeys.dtype == torch.float64 else i32)
    order = torch.sort(keys, stable=True).indices.to(i32)
    rects, valid = gaussian_rects(us, areas, valid, width, height)
    rects_s = rects[order.long()]
    valid_s = valid[order.long()]
    x0, y0, x1, y1 = rects_s[:, 0], rects_s[:, 1], rects_s[:, 2], rects_s[:, 3]

    # Per-gaussian table for the per-row extent test (original order):
    # mean, conic, skip-ellipse radius^2, AABB x-range.
    usg = us.to(f)
    if cinv2ds is not None:
        cg = cinv2ds.to(f)
        r2 = skip_radius2(alphas.to(f))
    else:
        cg = torch.zeros((n, 3), dtype=f, device=dev)
        cg[:, 0] = 1.0
        cg[:, 2] = 1.0
        r2 = torch.full((n,), torch.inf, dtype=f, device=dev)
    gtab = torch.cat(
        [usg, cg, r2[:, None], rects[:, 0:1].to(f), rects[:, 2:3].to(f)], dim=1
    )  # [N, 8]: ux uy A B C r2 x0 x1

    # Level 1: one slot per covered tile-row of each gaussian.
    row_counts = torch.where(valid_s, y1 - y0, 0).to(i32)
    rcum = torch.cumsum(row_counts, 0, dtype=i32)
    rstart = rcum - row_counts
    total_rows = rcum[-1]
    mr = torch.arange(max_rows, dtype=i32, device=dev)
    rows_ok = mr < torch.clamp(total_rows, max=max_rows)
    ty0_prop, row_ord = scan.batched_cumsum([
        _propagate_marks(rstart, y0 - rstart, max_rows),
        _propagate_marks(rstart, order, max_rows),
    ], cumsum=cumsum)
    row_ty = ty0_prop + mr  # tile-row of each row slot
    row_gs = torch.clamp(row_ord, 0, n - 1)

    # Per-row ellipse x-extent: for pixel rows dy in [dy0, dy1] the ellipse
    # A dx^2 + 2B dx dy + C dy^2 <= r2 has dx in [xc - sr, xc + sr] with
    # xc = -B dy / A and sr = sqrt(A r2 - det dy^2) / A; bounding xc and sr
    # independently over the interval is conservative.
    g = gtab[row_gs.long()]  # [max_rows, 8]
    ux, uy, ca, cb, cc = g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 4]
    r2r, rx0_aabb, rx1_aabb = g[:, 5], g[:, 6], g[:, 7]
    ftile = _scalar(TILE, usg)
    dy0 = row_ty.to(f) * ftile - uy
    dy1 = dy0 + (ftile - 1.0)
    det = torch.clamp(ca * cc - cb * cb, min=1e-12)
    ca_safe = torch.clamp(ca, min=1e-12)
    dy_min2 = torch.where(dy0 * dy1 > 0, torch.minimum(dy0 * dy0, dy1 * dy1), 0.0)
    disc = ca * r2r - det * dy_min2
    sr = torch.sqrt(torch.clamp(disc, min=0.0)) / ca_safe
    xc0 = -cb * dy0 / ca_safe
    xc1 = -cb * dy1 / ca_safe
    # half-pixel fp margin on both sides
    x_lo = ux + torch.minimum(xc0, xc1) - sr - 0.5
    x_hi = ux + torch.maximum(xc0, xc1) + sr + 0.5
    ex0 = torch.clamp(torch.floor(x_lo / ftile), rx0_aabb, rx1_aabb)
    ex1 = torch.clamp(torch.floor(x_hi / ftile) + 1.0, ex0, rx1_aabb)
    rx0 = ex0.to(i32)
    row_w_raw = torch.where(disc >= 0, (ex1 - ex0).to(i32), 0)
    row_w = torch.where(rows_ok, row_w_raw, 0).to(i32)

    # Level 2: one slot per covered tile of each row.
    wcum = cumsum(row_w[None])[0]
    total = wcum[-1]  # post-cull patch count before the budget cap
    kept = torch.clamp(total, max=max_patches)
    start2 = wcum - row_w
    base = row_ty * gx + rx0 - start2
    m = torch.arange(max_patches, dtype=i32, device=dev)
    in_range = m < kept
    prop_base, prop_ord = scan.batched_cumsum([
        _propagate_marks(start2, base, max_patches),
        _propagate_marks(start2, row_ord, max_patches),
    ], cumsum=cumsum)
    tile_id = torch.where(in_range, prop_base + m, n_tiles).to(i32)
    gsid = torch.where(in_range, prop_ord, -1).to(i32)

    # Per-tile ranges: count the kept slots of each tile.
    tile_cnt = torch.zeros(n_tiles + 1, dtype=i32, device=dev).index_add_(
        0, tile_id.long(), torch.ones_like(tile_id))[:n_tiles]
    tile_start = torch.cumsum(tile_cnt, 0, dtype=i32) - tile_cnt

    # Sort by tile id keeping the slot (= depth) order within each tile. Every
    # route is stable by (tile, slot), so their outputs are equal.
    mp_bits = max(1, (max_patches - 1).bit_length())
    if env_flag("EGS_RADIX_SORT"):
        # K8: a stable counting sort by tile (n_tiles is the padding bucket)
        by_tile = radix.counting_sort_by_tile if use_kernels else _counting_sort_by_tile_plain
        tile_sorted, gsid_sorted = by_tile(tile_id, gsid, n_tiles=n_tiles)
    elif use_kernels and (n_tiles + 1) << mp_bits > 2**32 and env_flag("EGS_LEX_SORT"):
        # K7 on the two-word key (tile, slot), where the JAX package's packed
        # one-word key overflows 32 bits; the unique slot makes it stable
        tile_sorted, _, gsid_sorted = sort.sort_pairs(tile_id, m, gsid, n_keys=2)
    else:
        tile_sorted, perm = torch.sort(tile_id, stable=True)
        gsid_sorted = gsid[perm]

    out = {
        "patch_gsid": gsid_sorted,
        "patch_tile": tile_sorted,
        "tile_start": tile_start,
        "tile_cnt": tile_cnt,
        "total": total,
        "n_dropped": total - kept,
        "total_rows": total_rows,
        "rows_dropped": total_rows - torch.clamp(total_rows, max=max_rows),
    }
    if gsid_counts:
        # A depth-sorted gaussian's patches are the expansion slots
        # [wcum_excl(rstart), wcum_excl(rstart + rows)), clipped to the row
        # and patch budgets as the expansion clips them.
        wcum_pad = torch.cat([wcum.new_zeros(1), wcum])
        lo_cnt = torch.minimum(wcum_pad[torch.clamp(rstart, 0, max_rows).long()], kept)
        hi_cnt = torch.minimum(
            wcum_pad[torch.clamp(rstart + row_counts, 0, max_rows).long()], kept)
        count_sorted = (hi_cnt - lo_cnt).to(i32)  # by depth rank
        if use_kernels and not env_flag("EGS_XLA_GRAD_SORT", default=True):
            # K7: sorting (order, counts) by the permutation inverts it
            _, counts = sort.sort_pairs(order, count_sorted)
        else:
            counts = torch.empty(n, dtype=i32, device=dev)
            counts[order.long()] = count_sorted
        out["gsid_counts"] = counts
    out["kernel"] = False
    return out


def skip_radius2(alphas):
    """Each gaussian's skip-ellipse radius^2: where alpha * exp(-q / 2)
    falls to ALPHA_SKIP, with a relative and an absolute margin."""
    ag = torch.clamp(alphas, min=1e-12)
    r2 = 2.0 * torch.log(ag / _scalar(ALPHA_SKIP, ag)) * (1.0 + 1e-5) + 1e-4
    return torch.clamp(r2, min=0.0)


def takes_kernel(us, use_kernels):
    """True where ``bin_gaussians`` builds its lists with K12: CUDA tensors on
    the kernel route and none of the opt-in sort routes (which keep the slot
    path, K7's and K8's)."""
    return (use_kernels and us.device.type == "cuda"
            and not env_flag("EGS_RADIX_SORT") and not env_flag("EGS_LEX_SORT")
            and env_flag("EGS_XLA_GRAD_SORT", default=True))


def _counting_sort_by_tile_plain(tile, *vals, n_tiles):
    return radix.counting_sort_plain(tile, *vals, key_bound=n_tiles + 1)


def dense_tile_lists(binning, *, max_per_tile):
    """[T, K] dense per-tile gaussian-index lists (-1 padded) from binning
    output. Convenience layout for tests."""
    tile_start = binning["tile_start"]
    tile_cnt = binning["tile_cnt"]
    gsid = binning["patch_gsid"]
    k = torch.arange(max_per_tile, dtype=torch.int32, device=gsid.device)[None, :]
    idx = torch.clamp(tile_start[:, None] + k, 0, gsid.shape[0] - 1)
    ok = k < tile_cnt[:, None]
    return torch.where(ok, gsid[idx.long()], -1)
