"""K1 and K2: the fused preprocess (stages 1-5 in one kernel) and its VJP.

Port of easygaussiansplatting_tpu/ops/pallas/preprocess.py (``_fwd_kernel``,
``_bwd_kernel``, ``_fused``, ``fused_preprocess``, ``offset_table``). The
forward kernel is ``csrc/preprocess.cu``; its plain version is
ops/stages.py, assembled into the same table by :func:`preprocess_plain`.
The backward kernel is ``csrc/preprocess_bwd.cu``; its plain version is the
autograd VJP of that chain (:func:`preprocess_bwd_plain`).
:class:`PreprocessFunction` joins the two under autograd.

Both write one table row per gaussian (``TABLE_COLS`` = 12 floats):
  0 ux, 1 uy, 2-4 conic (a, b, c), 5 alpha, 6-8 rgb, 9 depth, 10-11 extents.
The stage-6 kernels (ops/kernels/rasterize.py) gather rows of this table by
patch gaussian id; the public :func:`fused_preprocess` dict holds views of it
under the names the JAX package uses. Only the first ``LIVE_COLS`` = 9
columns carry a gradient: depth and the extents feed binning and the
visibility mask, which take none. The camera takes no gradient either, as in
the JAX package.
"""

import ctypes

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.utils.sh import SH_CONSTS

TABLE_COLS = 12
LIVE_COLS = 9  # ux uy, conic, alpha, rgb: the columns that take a gradient
CAM_LEN = 21  # Rcw(9) tcw(3) twc(3) fx fy cx cy limx limy
_SH_CONSTS = (ctypes.c_float * len(SH_CONSTS))(*np.asarray(SH_CONSTS, np.float32))


def camera_vector(cam):
    """The flat float32 camera vector the kernel takes (CAM_LEN values)."""
    return np.concatenate([
        np.asarray(cam.Rcw, np.float32).reshape(9),
        np.asarray(cam.tcw, np.float32).reshape(3),
        np.asarray(cam.twc, np.float32).reshape(3),
        np.asarray([cam.fx, cam.fy, cam.cx, cam.cy,
                    stages.fov_limit(cam.width, cam.fx),
                    stages.fov_limit(cam.height, cam.fy)], np.float32),
    ])


def pack_table(us, cinv2ds, alphas, colors, depths, areas):
    """Per-gaussian attributes -> the [N, TABLE_COLS] table layout."""
    return torch.cat(
        [us, cinv2ds, alphas[:, None], colors, depths[:, None], areas], dim=1
    ).contiguous()


def preprocess_plain(pws, shs, alphas, scales, rots, cam, sh_degree=3):
    """Plain PyTorch version of K1: ops/stages.py packed into the table."""
    o = stages.preprocess(pws, shs, alphas, scales, rots, cam, sh_degree=sh_degree)
    return pack_table(o["us"], o["cinv2ds"], o["alphas"], o["colors"],
                      o["depths"], o["areas"])


def _check_params(pws, shs, alphas, scales, rots):
    n = pws.shape[0] if pws.dim() == 2 else -1
    shapes = {"pws": (n, 3), "shs": (n, shs.shape[-1]), "alphas": (n,),
              "scales": (n, 3), "rots": (n, 4)}
    for name, t in zip(shapes, (pws, shs, alphas, scales, rots)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pws.device:
            raise ValueError(f"{name} is on {t.device}, pws on {pws.device}")
    return n


def preprocess_fwd(pws, shs, alphas, scales, rots, cam, sh_degree=3):
    """K1 wrapper: float32 contiguous parameters -> [N, TABLE_COLS] table.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which reads 16 bytes at a time: every parameter must be 16-byte
    aligned."""
    n = _check_params(pws, shs, alphas, scales, rots)
    n_bases = stages.sh_bases(shs.shape[1], sh_degree)
    if pws.device.type == "cpu":
        return preprocess_plain(pws, shs, alphas, scales, rots, cam, sh_degree)
    if pws.device.type != "cuda":
        raise ValueError(f"unsupported device {pws.device}")
    if any(t.data_ptr() % 16 for t in (pws, shs, alphas, scales, rots)):
        raise ValueError("pws, shs, alphas, scales and rots must be 16-byte aligned")
    out = torch.empty((n, TABLE_COLS), dtype=torch.float32, device=pws.device)
    camv = (ctypes.c_float * CAM_LEN)(*camera_vector(cam))
    lib = _build.library()
    _build.check(lib.egs_preprocess_fwd(
        pws.data_ptr(), shs.data_ptr(), alphas.data_ptr(), scales.data_ptr(),
        rots.data_ptr(), ctypes.cast(camv, ctypes.c_void_p),
        ctypes.cast(_SH_CONSTS, ctypes.c_void_p), out.data_ptr(), n, n_bases,
        _build.stream_ptr(pws)), "egs_preprocess_fwd")
    preprocess_fwd.launches += 1
    return out


preprocess_fwd.launches = 0


def table_views(table, alphas, alive=None):
    """The JAX ``fused_preprocess`` dict (us, cinv2ds, colors, alphas,
    depths, areas, valid) as views of the [N, TABLE_COLS] table."""
    depths = table[:, 9]
    valid = depths >= stages.MIN_DEPTH
    if alive is not None:
        valid = valid & alive
    return {
        "us": table[:, 0:2],
        "cinv2ds": table[:, 2:5],
        "colors": table[:, 6:9],
        "alphas": alphas,
        "depths": depths,
        "areas": table[:, 10:12],
        "valid": valid,
    }


def fused_preprocess(pws, shs, alphas, scales, rots, cam, alive=None, sh_degree=3):
    """Drop-in for stages.preprocess on the kernel path (no gradient).

    Returns :func:`table_views` plus ``table``, the [N, TABLE_COLS] table the
    stage-6 kernel reads."""
    table = preprocess_fwd(pws, shs, alphas, scales, rots, cam, sh_degree)
    return {"table": table, **table_views(table, alphas, alive)}


def offset_table(table, us_offset):
    """Shift the table's screen coordinates (columns 0:2) by the
    densification ``us_offset`` [N, 2] (or None); returns (table, us)."""
    if us_offset is not None:
        table = table + torch.nn.functional.pad(us_offset, (0, TABLE_COLS - 2))
    return table, table[:, 0:2]


def preprocess_bwd_plain(pws, shs, alphas, scales, rots, dtable, cam, sh_degree=3):
    """Plain PyTorch version of K2: the autograd VJP of the plain K1 chain
    from the cotangent of the table's live columns. Returns (d_pws, d_shs,
    d_alphas, d_scales, d_rots)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (pws, shs, alphas, scales, rots)]
        table = preprocess_plain(*inputs, cam, sh_degree)
        return torch.autograd.grad(table[:, :LIVE_COLS], inputs, dtable[:, :LIVE_COLS])


def preprocess_bwd(pws, shs, alphas, scales, rots, dtable, cam, sh_degree=3):
    """K2 wrapper: the VJP of K1 from ``dtable`` [N, TABLE_COLS] (columns
    LIVE_COLS and up are ignored) to (d_pws, d_shs, d_alphas, d_scales,
    d_rots). CPU tensors take the plain version; CUDA tensors launch the
    kernel, which reads and writes 16 bytes at a time: pws, shs, scales,
    rots and dtable must be 16-byte aligned."""
    n = _check_params(pws, shs, alphas, scales, rots)
    n_bases = stages.sh_bases(shs.shape[1], sh_degree)
    if (dtable.dtype != torch.float32 or tuple(dtable.shape) != (n, TABLE_COLS)
            or not dtable.is_contiguous() or dtable.device != pws.device):
        raise ValueError(f"dtable must be contiguous float32 [{n}, {TABLE_COLS}] on "
                         f"{pws.device}, got {dtable.dtype} {tuple(dtable.shape)} on "
                         f"{dtable.device}")
    if pws.device.type == "cpu":
        return preprocess_bwd_plain(pws, shs, alphas, scales, rots, dtable, cam, sh_degree)
    if pws.device.type != "cuda":
        raise ValueError(f"unsupported device {pws.device}")
    if any(t.data_ptr() % 16 for t in (pws, shs, scales, rots, dtable)):
        raise ValueError("pws, shs, scales, rots and dtable must be 16-byte aligned")
    grads = tuple(torch.empty_like(t) for t in (pws, shs, alphas, scales, rots))
    camv = (ctypes.c_float * CAM_LEN)(*camera_vector(cam))
    _build.check(_build.library().egs_preprocess_bwd(
        pws.data_ptr(), shs.data_ptr(), alphas.data_ptr(), scales.data_ptr(),
        rots.data_ptr(), dtable.data_ptr(), ctypes.cast(camv, ctypes.c_void_p),
        ctypes.cast(_SH_CONSTS, ctypes.c_void_p), *(g.data_ptr() for g in grads), n,
        n_bases, _build.stream_ptr(pws)), "egs_preprocess_bwd")
    preprocess_bwd.launches += 1
    return grads


preprocess_bwd.launches = 0


def kernel_info(kernel, sh_degree=3):
    """What the compiled K1 (``kernel`` "fwd") or K2 ("bwd") kernel for
    ``sh_degree`` takes on the card: {"registers": per thread,
    "shared_bytes": per block, "local_bytes": per thread (spills),
    "blocks_per_sm": resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "threads": per block}.
    Builds the kernels first if needed; needs the card."""
    entry = {"fwd": "egs_preprocess_fwd_info", "bwd": "egs_preprocess_bwd_info"}[kernel]
    out = (ctypes.c_int * 5)()
    _build.check(getattr(_build.library(), entry)((sh_degree + 1) ** 2, ctypes.addressof(out)),
                 entry)
    return dict(zip(("registers", "shared_bytes", "local_bytes", "blocks_per_sm", "threads"),
                    out))


class PreprocessFunction(torch.autograd.Function):
    """table = K1(params), with K2 as its backward. ``use_kernels=False``
    runs the plain versions on any device (the all-plain path)."""

    @staticmethod
    def forward(ctx, pws, shs, alphas, scales, rots, cam, sh_degree, use_kernels):
        fwd = preprocess_fwd if use_kernels else preprocess_plain
        table = fwd(pws, shs, alphas, scales, rots, cam, sh_degree)
        ctx.save_for_backward(pws, shs, alphas, scales, rots)
        ctx.cam, ctx.sh_degree, ctx.use_kernels = cam, sh_degree, use_kernels
        return table

    @staticmethod
    def backward(ctx, dtable):
        bwd = preprocess_bwd if ctx.use_kernels else preprocess_bwd_plain
        grads = bwd(*ctx.saved_tensors, dtable.contiguous(), ctx.cam, ctx.sh_degree)
        return (*grads, None, None, None)
