"""Image metrics and output: PSNR, and an 8-bit RGB PNG writer on the
standard library alone."""

import struct
import zlib

import numpy as np
import torch


def psnr(img, ref, max_val=1.0):
    """Peak signal-to-noise ratio between two image tensors of one shape;
    port of the JAX package's ``utils.image.psnr``."""
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(max_val**2 / mse)


def to_uint8(img):
    """[3,H,W] float image in [0,1] -> [H,W,3] uint8, clipped, as the JAX
    render CLI converts it."""
    return (np.clip(np.transpose(np.asarray(img), (1, 2, 0)), 0, 1) * 255).astype(np.uint8)


def save_png(path, rgb):
    """Write an [H,W,3] uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected [H,W,3] RGB, got {rgb.shape}")

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 per row
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
