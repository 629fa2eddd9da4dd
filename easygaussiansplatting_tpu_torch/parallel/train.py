"""Sharded and banded training steps and the sharded render.

Port of easygaussiansplatting_tpu/parallel/train.py (``stack_cameras``,
``pool_shardings``, ``shard_pool``, ``shard_batch``,
``make_sharded_train_step``, ``make_banded_train_step``,
``make_sharded_render``) onto a :class:`Mesh` of ranks. JAX's GSPMD and
``shard_map`` placed the collectives; here they are written out
(parallel/collectives.py):

* **the batched step**: rank (d, g) holds pool rows g·cap/gs … (g+1)·cap/gs
  (parameters, Adam moments, density stats) and renders data row d's
  cameras. Per camera it runs K1 on its rows, all-gathers the [cap/gs, 12]
  tables over gs into the full table, bins and blends it (K3, K4; K5, K6 in
  the backward) and keeps its own rows of the table's cotangent for K2.
  The ranks of a data row rasterise the same cameras, as JAX's
  ``shard_map`` over ``P("data")`` does, so no reduce over gs is needed;
  the parameter and ``us_offset`` gradients are summed over data. This is
  JAX's fused path (its TPU default): the port always builds the K1 table.
* **the banded step and render**: one camera over every rank, each
  rendering a band of tile rows (and, in training, a one-tile halo). The
  table is gathered as above; in the backward each band's table cotangent
  is summed over every rank before this rank keeps its rows, the transpose
  of JAX's replicated ``shard_map`` inputs.

Band budgets keep JAX's shares (5/2 of the even share in training, 4x
capped at ``max_patches`` in the render) without its ``keff`` rounding to
the Pallas chunk: the port has no ``k_chunk`` (train/config.py). Unlike
JAX, the banded step reports its bands' drops, and the render bands on
every backend (JAX bands on Pallas only, since GSPMD partitions its tiled
rasteriser).

Every step updates this rank's pool, Adam state and stats in place and
returns (loss, binfo), as train/loop.py's step does; ``loss`` and
``binfo["dropped"]`` (patches and rows dropped) are the same on every rank.
"""

import dataclasses

import torch
import torch.nn.functional as F

from easygaussiansplatting_tpu_torch.ops.binning import TILE
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import (
    TABLE_COLS,
    PreprocessFunction,
    offset_table,
    table_views,
)
from easygaussiansplatting_tpu_torch.ops.loss import _depthwise_blur, gau_loss
from easygaussiansplatting_tpu_torch.ops.rasterize import raster_from_aux, resolve_backend
from easygaussiansplatting_tpu_torch.ops.stages import MIN_DEPTH
from easygaussiansplatting_tpu_torch.parallel.collectives import (
    GatherRows,
    all_gather,
    all_reduce_,
    gather_rows,
)
from easygaussiansplatting_tpu_torch.parallel.distributed import (
    put_batch,
    put_replicated,
    rank_rows,
)
from easygaussiansplatting_tpu_torch.train.density import update_density_stats
from easygaussiansplatting_tpu_torch.train.loop import check_finite
from easygaussiansplatting_tpu_torch.train.optimizer import adam_update, make_lr_fns

ALPHA_COL = 5  # the table's alpha column: the activated alpha, as K1 copies it
Y_COL = 1
DEPTH_COL = 9


def stack_cameras(cams):
    """A batch of cameras (equal W, H) as one tuple, ids cleared (they are
    per-camera meta); the port's steps take cameras one by one."""
    w, h = cams[0].width, cams[0].height
    if any(c.width != w or c.height != h for c in cams):
        raise ValueError("stack_cameras requires equal image sizes")
    return tuple(dataclasses.replace(c, id=0) for c in cams)


def pool_shardings(mesh, capacity, axis_name="gs"):
    """This rank's rows of a pool of ``capacity`` (a slice): the port's
    sharding of a pool is a block of rows."""
    return rank_rows(mesh, capacity, axis_name)


def shard_pool(mesh, *trees, axis_name="gs"):
    """This rank's rows of each full pool, Adam state or stats."""
    out = tuple(put_replicated(mesh, t, axis_name) for t in trees)
    return out[0] if len(out) == 1 else out


shard_batch = put_batch  # this rank's rows of a global batch, under JAX's name here


def _backend(config, pool):
    backend = resolve_backend(config.backend, pool.pws.device)
    if backend == "dense":
        raise ValueError("the sharded steps and render take the 'cuda' or 'tiled' backend")
    return backend == "cuda"


def _gathered_table(pool, cam, config, mesh, use_kernels, us_offset=None, reduce_axis=None):
    """K1 on this rank's rows, shifted by ``us_offset``, all-gathered over
    gs: (the full [cap, 12] table, this rank's table rows)."""
    pws, shs, alphas, scales, rots, _ = pool.activated()
    table = PreprocessFunction.apply(pws, shs, alphas, scales, rots, cam, config.sh_degree,
                                     use_kernels)
    table, _ = offset_table(table, us_offset)
    if torch.is_grad_enabled():
        full = GatherRows.apply(table, mesh, "gs", "table", reduce_axis)
    else:
        full = gather_rows(table, mesh, "gs", "table")
    return full, table


def _gathered_alive(pool, mesh):
    return gather_rows(pool.alive.to(torch.uint8), mesh, "gs", "alive").bool()


def _raster(full, alive, config, use_kernels, width, height, max_patches, max_rows,
            need_grads, y0=0):
    """Bin and blend the full table, its screen y shifted up by ``y0`` rows:
    (image [3, height, W], patches and rows dropped)."""
    if y0:
        shift = torch.zeros(TABLE_COLS, dtype=full.dtype, device=full.device)
        shift[Y_COL] = y0
        full = full - shift
    aux = table_views(full, full[:, ALPHA_COL], alive)
    backend = "cuda" if use_kernels else "tiled"
    image, raux = raster_from_aux(
        *(aux[k] for k in ("us", "cinv2ds", "alphas", "colors", "depths", "areas", "valid")),
        width=width, height=height, backend=backend, max_patches=max_patches,
        max_rows=max_rows, need_grads=need_grads, table=full)
    b = raux["binning"]
    return image, b["n_dropped"] + b["rows_dropped"]


def _update(pool, adam_state, stats, out, lr_fns, config, debug_nans):
    """Masked Adam on this rank's rows and the density stats, from a
    ``*_loss_and_grads`` result; returns (loss, binfo)."""
    loss, grads, visible, dropped = out
    if debug_nans:
        check_finite(loss, grads)
    grads = dict(grads)
    g_us = grads.pop("us_offset")
    adam_update(grads, adam_state, pool.params(), lr_fns,
                b1=config.adam_b1, b2=config.adam_b2, eps=config.adam_eps)
    update_density_stats(stats, g_us, visible & pool.alive)
    return loss, {"dropped": dropped}


def sharded_loss_and_grads(mesh, pool, cams, gt_images, config):
    """The batched step's loss and gradients, changing nothing: (the mean
    loss over the global batch; {group: gradient, and "us_offset": the
    screen gradient} on this rank's rows, summed over data; the rows in
    front of a camera of the batch; patches and rows dropped over the
    batch). ``loss`` and the drops are the same on every rank."""
    use_kernels = _backend(config, pool)
    batch = len(cams) * mesh.shape["data"]
    params = pool.params()
    us_offset = torch.zeros((pool.capacity, 2), dtype=torch.float32, device=pool.pws.device,
                            requires_grad=True)
    alive = _gathered_alive(pool, mesh)
    total, dropped = 0.0, 0
    visible = torch.zeros(pool.capacity, dtype=torch.bool, device=pool.pws.device)
    for cam, gt in zip(cams, gt_images):
        full, table = _gathered_table(pool, cam, config, mesh, use_kernels, us_offset)
        image, drops = _raster(full, alive, config, use_kernels, cam.width, cam.height,
                               config.max_patches, config.max_rows, need_grads=True)
        total = total + gau_loss(image, gt, config.loss_lambda)
        dropped = dropped + drops
        visible |= table[:, DEPTH_COL].detach() >= MIN_DEPTH
    loss = total / batch
    grads = torch.autograd.grad(loss, [*params.values(), us_offset])
    # one all-reduce over data for every gradient, us_offset's included: the
    # density stats take the norm of the batch's summed screen gradient
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh, "data", "grads")
    grads = [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]
    visible = all_reduce_(visible.to(torch.uint8), mesh, "data", "visible", op="max").bool()
    loss = all_reduce_(loss.detach().clone(), mesh, "data", "loss")
    dropped = all_reduce_(dropped.to(torch.int32), mesh, "data", "dropped")
    return loss, dict(zip([*params, "us_offset"], grads)), visible, dropped


def make_sharded_train_step(mesh, config, scene_size, max_steps, debug_nans=False):
    """Batched step over the mesh. Returns
    ``step(pool, adam_state, stats, cams, gt_images) -> (loss, binfo)``:
    ``pool``, ``adam_state``, ``stats`` are this rank's rows
    (:func:`shard_pool`), ``cams`` its data row's cameras
    (:func:`shard_batch` of a :func:`stack_cameras` batch) and
    ``gt_images`` their [3,H,W] images. The gradients are those of the mean
    loss over the global batch, which ``loss`` is; the density stats take
    the norm of the screen gradient summed over the batch and the
    visibility OR-ed over it (:func:`sharded_loss_and_grads`).
    ``debug_nans`` checks the loss and the reduced gradients as
    train/loop.py's step does."""
    lr_fns = make_lr_fns(config, scene_size, max_steps)

    def step(pool, adam_state, stats, cams, gt_images):
        out = sharded_loss_and_grads(mesh, pool, cams, gt_images, config)
        return _update(pool, adam_state, stats, out, lr_fns, config, debug_nans)

    return step


def band_height(height, n_bands):
    """Each band's height in pixels: whole tile rows, the image's tile rows
    split over ``n_bands`` and rounded up."""
    tile_rows = -(-height // TILE)
    return -(-tile_rows // n_bands) * TILE


def band_budgets(config, n_bands, training):
    """(max_patches, max_rows) of one band: 5/2 of the even share in
    training, 4x it (capped at the config's budgets) in the render, rounded
    up."""
    num, den = (5, 2) if training else (4, 1)

    def share(budget):
        b = max(1, -(-budget * num // (den * n_bands)))
        return b if training else min(budget, b)

    return share(config.max_patches), None if config.max_rows is None else share(config.max_rows)


HALO = TILE  # the banded step's halo: one tile row, which covers the SSIM window's radius
assert HALO >= 5, "band halo (one tile row) must cover the SSIM window"


def banded_loss_and_grads(mesh, pool, cam, gt_image, config):
    """The banded step's loss and gradients, changing nothing: (the loss of
    the whole image; {group: gradient, "us_offset": the screen gradient} on
    this rank's rows, every band's share summed; this rank's rows in front
    of the camera; every band's patch and row drops).

    The decomposition is exact: the SSIM blur is a zero-padded 11x11
    window (ops/loss.py), so a pixel's SSIM term reads rows within 5, inside
    the halo, and rows outside the image are zero on both operands, as the
    whole image's zero padding makes them. Each band sums L1 and the SSIM
    map over the rows it owns; the sums are all-reduced."""
    use_kernels = _backend(config, pool)
    n_bands = mesh.size
    mp, mrows = band_budgets(config, n_bands, training=True)
    lam = config.loss_lambda
    h, w = cam.height, cam.width
    sub_h = band_height(h, n_bands)
    h_loc = sub_h + 2 * HALO
    npix = 3 * h * w
    d = mesh.index("all")
    y0 = d * sub_h - HALO  # the image row of band row 0 (may be < 0)
    params = pool.params()
    us_offset = torch.zeros((pool.capacity, 2), dtype=torch.float32, device=pool.pws.device,
                            requires_grad=True)
    full, table = _gathered_table(pool, cam, config, mesh, use_kernels, us_offset,
                                  reduce_axis="all")
    image, dropped = _raster(full, _gathered_alive(pool, mesh), config, use_kernels, w, h_loc,
                             mp, mrows, need_grads=True, y0=y0)
    rows = y0 + torch.arange(h_loc, device=image.device)
    in_img = ((rows >= 0) & (rows < h))[None, :, None]
    owned = in_img & ((rows >= d * sub_h) & (rows < (d + 1) * sub_h))[None, :, None]
    # rows outside the image are zero on both operands: the whole image's
    # blur zero-pads there
    image = torch.where(in_img, image, 0.0)
    gt = torch.as_tensor(gt_image, dtype=torch.float32, device=image.device)
    gt_b = F.pad(gt, (0, 0, HALO, sub_h * n_bands + HALO - h))[:, d * sub_h:d * sub_h + h_loc]
    l1_sum = torch.sum(torch.where(owned, torch.abs(image - gt_b), 0.0))
    mu1, mu2 = _depthwise_blur(image), _depthwise_blur(gt_b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _depthwise_blur(image * image) - mu1_sq
    s2 = _depthwise_blur(gt_b * gt_b) - mu2_sq
    s12 = _depthwise_blur(image * gt_b) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    smap = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    ssim_sum = torch.sum(torch.where(owned, smap, 0.0))
    # this band's share of the loss (the constant lam * 1 joins after the
    # reduce); the gather's backward sums the shares' table cotangents
    share = (1.0 - lam) * l1_sum / npix - lam * ssim_sum / npix
    grads = torch.autograd.grad(share, [*params.values(), us_offset])
    sums = all_reduce_(torch.stack([l1_sum, ssim_sum]).detach(), mesh, "all", "loss")
    loss = (1.0 - lam) * sums[0] / npix + lam * (1.0 - sums[1] / npix)
    dropped = all_reduce_(dropped.to(torch.int32), mesh, "all", "dropped")
    visible = table[:, DEPTH_COL].detach() >= MIN_DEPTH
    return loss, dict(zip([*params, "us_offset"], grads)), visible, dropped


def make_banded_train_step(mesh, config, scene_size, max_steps, debug_nans=False):
    """One camera over every rank of the mesh in bands of tile rows, each
    with a one-tile halo (:func:`banded_loss_and_grads`). Returns
    ``step(pool, adam_state, stats, cam, gt_image [3,H,W]) -> (loss,
    binfo)`` on this rank's rows; ``binfo["dropped"]`` sums every band's
    patch and row drops. ``debug_nans`` as in
    :func:`make_sharded_train_step`."""
    lr_fns = make_lr_fns(config, scene_size, max_steps)

    def step(pool, adam_state, stats, cam, gt_image):
        out = banded_loss_and_grads(mesh, pool, cam, gt_image, config)
        return _update(pool, adam_state, stats, out, lr_fns, config, debug_nans)

    return step


def make_sharded_render(mesh, config, *, tile_sharded=None, with_aux=False):
    """Whole-image render of this rank's pool rows: ``render_fn(pool, cam)
    -> image [3,H,W]`` (and ``{"n_dropped": patches and rows dropped}`` with
    ``with_aux``), the same on every rank.

    The table is gathered over gs. With ``tile_sharded`` (default: more than
    one rank) each rank bins and blends a band of tile rows under its band
    budget and the bands are all-gathered, so one image's latency scales
    with the mesh; otherwise every rank renders the whole image."""
    n_bands = mesh.size
    if tile_sharded is None:
        tile_sharded = n_bands > 1
    use_bands = tile_sharded and n_bands > 1
    mp, mrows = band_budgets(config, n_bands, training=False)

    @torch.no_grad()
    def render_fn(pool, cam):
        use_kernels = _backend(config, pool)
        full, _ = _gathered_table(pool, cam, config, mesh, use_kernels)
        alive = _gathered_alive(pool, mesh)
        if use_bands:
            sub_h = band_height(cam.height, n_bands)
            band, dropped = _raster(full, alive, config, use_kernels, cam.width, sub_h, mp,
                                    mrows, need_grads=False, y0=mesh.index("all") * sub_h)
            img = torch.cat(all_gather(band, mesh, "all", "bands"), dim=1)[:, :cam.height]
            dropped = all_reduce_(dropped.to(torch.int32), mesh, "all", "dropped")
        else:
            img, dropped = _raster(full, alive, config, use_kernels, cam.width, cam.height,
                                   config.max_patches, config.max_rows, need_grads=False)
        return (img, {"n_dropped": dropped}) if with_aux else img

    return render_fn
