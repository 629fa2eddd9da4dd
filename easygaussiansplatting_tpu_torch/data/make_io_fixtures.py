"""Write the photo-decoding fixtures of data/io_fixtures/.

    python -m easygaussiansplatting_tpu_torch.data.make_io_fixtures

Needs PIL, and is the one module of the port besides data/image_io.py's CPU
JPEG branch that imports it. It writes small seeded test photos:

* JPEGs, encoded by PIL at quality 90, at odd sizes: chroma 4:2:0, 4:2:2
  and 4:4:4, grayscale, progressive, and one with restart markers;
* PNGs of the five 8-bit colour types (L, RGB, P, LA, RGBA) by
  :func:`encode_png`, whose rows take the five PNG filters in turn (PIL's
  own encoder never picks the Average filter);

and ``reference.npz``: for every file, PIL's decode (``convert("RGB")``) and
PIL's ``resize`` at rates 0.5 and 0.3 (then ``convert("RGB")``), as uint8
[H,W,3]. chip_smoke.py and tests/test_torch_cuda.py hold nvJPEG and the
CUDA resize against these arrays on the card, where PIL is not installed.

The photos have smooth colour and luma stripes (vertical in the top half,
horizontal in the bottom) with a bright top-left corner, so that a channel
swap, one row shifted along itself in the top half, and the first 16x16 MCU
zeroed each move many levels.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

from easygaussiansplatting_tpu_torch.data.image_io import PNG_SIGNATURE, PNG_TYPES

FIXTURES = Path(__file__).resolve().parent / "io_fixtures"
RATES = (0.5, 0.3)

# name -> (width, height, PIL save options); a subsampling of None is grayscale
JPEGS = {
    "jpeg_420.jpg": (97, 73, {"subsampling": "4:2:0"}),
    "jpeg_422.jpg": (90, 61, {"subsampling": "4:2:2"}),
    "jpeg_444.jpg": (67, 45, {"subsampling": "4:4:4"}),
    "jpeg_gray.jpg": (75, 53, {"subsampling": None}),
    "jpeg_progressive.jpg": (81, 59, {"subsampling": "4:2:0", "progressive": True}),
    "jpeg_restart.jpg": (96, 64, {"subsampling": "4:2:0", "restart_marker_blocks": 2}),
}
# name -> (width, height, PNG colour type)
PNGS = {
    "png_L.png": (61, 43, 0),
    "png_RGB.png": (57, 41, 2),
    "png_P.png": (47, 35, 3),
    "png_LA.png": (53, 37, 4),
    "png_RGBA.png": (59, 39, 6),
}


def photo(width, height, seed):
    """A seeded uint8 [H,W,3] test photo (see the module docstring)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    colour = np.stack([150 + 45 * np.cos(x / (19 + 4 * c) + phase[c]) * np.cos(y / 23)
                       - 0.4 * (x + y) for c in range(3)], axis=-1)
    colour[:16, :16] = np.maximum(colour[:16, :16], 170)
    stripes = np.where(y < height // 2, 28 * np.sin(2 * np.pi * x / 7),
                       28 * np.sin(2 * np.pi * y / 5))
    img = colour + stripes[..., None] + rng.normal(scale=2.0, size=(height, width, 1))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def filter_rows(pixels, bpp):
    """PNG image data of uint8 rows [H, stride]: row y takes filter y % 5
    (None, Sub, Up, Average, Paeth)."""
    out, prev = [], np.zeros(pixels.shape[1], np.int32)
    for y, row in enumerate(pixels.astype(np.int32)):
        kind = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([kind]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def encode_png(pixels, ctype, palette=None):
    """An 8-bit PNG of colour type ``ctype`` from uint8 ``pixels`` [H,W,C]
    (C = 1 for types 0 and 3), rows filtered by :func:`filter_rows`;
    ``palette`` [n,3] uint8 for type 3. Returns its bytes."""
    h, w = pixels.shape[:2]
    bpp = PNG_TYPES[ctype][1]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    body += _chunk(b"IDAT", zlib.compress(filter_rows(pixels.reshape(h, w * bpp), bpp), 9))
    return PNG_SIGNATURE + body + _chunk(b"IEND", b"")


def png_pixels(width, height, ctype, seed):
    """(pixels, palette) of a PNG fixture: the test photo in the colour
    type's layout; alpha (types 4, 6) has a fifth of its values 0 and a
    fifth 255, a palette image (type 3) takes 256 colours quantised from
    the photo."""
    rgb = photo(width, height, seed)
    rng = np.random.default_rng(seed + 100)
    alpha = rng.integers(1, 255, size=(height, width, 1)).astype(np.uint8)
    u = rng.uniform(size=(height, width, 1))
    alpha[u < 0.2], alpha[u > 0.8] = 0, 255
    grey = np.rint(rgb @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)[..., None]
    if ctype == 0:
        return grey, None
    if ctype == 2:
        return rgb, None
    if ctype == 4:
        return np.concatenate([grey, alpha], axis=-1), None
    if ctype == 6:
        return np.concatenate([rgb, alpha], axis=-1), None
    palette = rng.integers(0, 256, size=(256, 3)).astype(np.uint8)
    index = ((rgb[..., 0].astype(np.int32) >> 5) * 32 + (rgb[..., 1] >> 5) * 4
             + (rgb[..., 2] >> 6)).astype(np.uint8)
    return index[..., None], palette


def planted_faults(rgb):
    """Faulty copies of a decoded fixture (uint8 [H,W,3]) that the nvJPEG
    limits must refuse: the channels swapped (colour photos only: a grey
    one is its own swap), one row of the striped top half shifted 4
    pixels along itself, and the first 16x16 MCU zeroed. name -> array."""
    faults = {}
    if not (rgb[..., 0] == rgb[..., 1]).all():
        faults["channels swapped"] = rgb[..., ::-1]
    row = rgb.copy()
    row[rgb.shape[0] // 4] = np.roll(row[rgb.shape[0] // 4], 4, axis=0)
    faults["one row shifted"] = row
    mcu = rgb.copy()
    mcu[:16, :16] = 0
    faults["one MCU zeroed"] = mcu
    return faults


def main():
    import io

    from PIL import Image

    FIXTURES.mkdir(exist_ok=True)
    ref = {}
    for i, (name, (w, h, opts)) in enumerate(JPEGS.items()):
        opts = dict(opts)
        sub = opts.pop("subsampling")
        img = photo(w, h, seed=i)
        im = (Image.fromarray(np.rint(img @ np.array([0.299, 0.587, 0.114])).astype(np.uint8), "L")
              if sub is None else Image.fromarray(img, "RGB"))
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=90, **({} if sub is None else {"subsampling": sub}), **opts)
        (FIXTURES / name).write_bytes(buf.getvalue())
    for i, (name, (w, h, ctype)) in enumerate(PNGS.items()):
        pixels, palette = png_pixels(w, h, ctype, seed=10 + i)
        (FIXTURES / name).write_bytes(encode_png(pixels, ctype, palette))
    for name in (*JPEGS, *PNGS):
        with Image.open(FIXTURES / name) as im:
            ref[f"decode/{name}"] = np.asarray(im.convert("RGB"))
            for rate in RATES:
                size = (max(1, round(im.width * rate)), max(1, round(im.height * rate)))
                ref[f"resize{rate}/{name}"] = np.asarray(im.resize(size).convert("RGB"))
    np.savez_compressed(FIXTURES / "reference.npz", **ref)
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    print(f"wrote {len(JPEGS) + len(PNGS)} photos and reference.npz to {FIXTURES} "
          f"({total} bytes)")


if __name__ == "__main__":
    main()
