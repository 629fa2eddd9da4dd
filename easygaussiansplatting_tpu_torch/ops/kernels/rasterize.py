"""K4: stage-6 forward blend.

Port of ops/pallas/kernels.py ``forward_kernel`` and the forward half of
ops/pallas/rasterize.py ``rasterize_pallas``. The kernel is
``csrc/rasterize_fwd.cu``; its plain version is ops/rasterize_tiled.py with
ops/blend.py. What ``rasterize_pallas`` does around its kernel is done by the
CUDA kernel itself or is not needed: it gathers table rows through
``patch_gsid`` (no packed per-patch array), fills empty tiles, and writes
[3,H,W] / [H,W] directly (no [T,3,P] relayout). The chunk x tile segment
layout of the TPU grid (``binning.segment_layout``) has no counterpart: a
block per tile reads its own range.
"""

import torch

from easygaussiansplatting_tpu_torch.ops.binning import num_tiles
from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import TABLE_COLS
from easygaussiansplatting_tpu_torch.ops.rasterize_tiled import rasterize_tiled


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

