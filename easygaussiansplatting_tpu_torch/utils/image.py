"""Image metrics and output: PSNR, the point-cloud rainbow colormap, and an
8-bit RGB PNG encoder on the standard library alone."""

import struct
import zlib

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.utils.sh import SH_C0


def psnr(img, ref, max_val=1.0):
    """Peak signal-to-noise ratio between two image tensors of one shape;
    port of the JAX package's ``utils.image.psnr``."""
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(max_val**2 / mse)


def rainbow_sh(scalars, scalar_min=0.0, scalar_max=255.0):
    """Map scalars to rainbow RGB and convert to degree-0 SH coefficients.

    Port of the JAX package's ``utils.image.rainbow_sh`` (numpy on both
    sides, so it is bit-equal): a 5-segment ramp (blue -> cyan -> green ->
    yellow -> red), inverted so small values are red; returns
    (rgb - 0.5) / Y0.
    """
    s = np.asarray(scalars, np.float32).reshape(-1)
    v = np.clip(1.0 - (s - scalar_min) / (scalar_max - scalar_min), 0.0, 1.0)
    h = v * 5.0 + 1.0
    i = np.floor(h).astype(np.int32)
    f = h - i
    f = np.where(i % 2 == 0, 1.0 - f, f)
    n = 1.0 - f
    colors = np.zeros((s.shape[0], 3), np.float32)
    colors[i <= 1] = np.stack([n, np.zeros_like(n), np.ones_like(n)], 1)[i <= 1]
    colors[i == 2] = np.stack([np.zeros_like(n), n, np.ones_like(n)], 1)[i == 2]
    colors[i == 3] = np.stack([np.zeros_like(n), np.ones_like(n), n], 1)[i == 3]
    colors[i == 4] = np.stack([n, np.ones_like(n), np.zeros_like(n)], 1)[i == 4]
    colors[i >= 5] = np.stack([np.ones_like(n), n, np.zeros_like(n)], 1)[i >= 5]
    return (colors - 0.5) / SH_C0[0]


def frame_u8(img):
    """[3,H,W] float tensor in [0,1] -> contiguous [H,W,3] uint8 tensor on
    its device, as the JAX render CLI converts it: clipped, multiplied by
    255 in the image's float type and truncated."""
    return (torch.clamp(img, 0.0, 1.0).permute(1, 2, 0) * 255).to(torch.uint8).contiguous()


def to_uint8(img):
    """:func:`frame_u8` of a host [3,H,W] float array, as a numpy array."""
    return frame_u8(torch.tensor(np.asarray(img))).numpy()


def encode_png(rgb):
    """An [H,W,3] uint8 array -> the bytes of an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] RGB, got {rgb.shape}")
    h, w, _ = rgb.shape

    def chunk(tag, data):
        body = tag + data
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + body + struct.pack(">I", crc)

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_png(path, rgb):
    """Write an [H,W,3] uint8 array as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
