"""PyTorch port: photo decode and the Pillow-exact resize (data/image_io.py)
against the JAX package's ``load_image`` (PIL) on the CPU.

Every comparison is exact (np.array_equal): the PNG decoder, the C
unfilter, the CPU JPEG route and the resize are integer code that matches
Pillow bit for bit. nvJPEG, which decodes JPEG on a CUDA device, is held to
the committed archive in tests/test_torch_cuda.py.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from easygaussiansplatting_tpu.data.dataset import load_image as jax_load_image
from easygaussiansplatting_tpu_torch.data import image_io
from easygaussiansplatting_tpu_torch.data.dataset import load_image
from easygaussiansplatting_tpu_torch.data.make_io_fixtures import (
    FIXTURES,
    JPEGS,
    PNGS,
    RATES,
    encode_png,
    photo,
    png_pixels,
)

RESIZE_RATES = (1.0, 0.5, 0.3, 0.25, 0.123)
PIL_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _pil_png(ctype, w, h, seed):
    """A PNG written by PIL's own encoder (which picks None, Sub, Up and
    Paeth rows, never Average) of the fixture photo in colour type ctype."""
    pixels, palette = png_pixels(w, h, ctype, seed)
    if ctype == 3:
        im = Image.fromarray(pixels[..., 0], "P")
        im.putpalette(palette.tobytes())
    else:
        im = Image.fromarray(pixels[..., 0] if pixels.shape[-1] == 1 else pixels,
                             PIL_MODES[ctype])
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def _filters(data, h, stride):
    raw = zlib.decompress(b"".join(
        data[p + 8:p + 8 + n] for p, n in _chunks(data) if data[p + 4:p + 8] == b"IDAT"))
    return {raw[y * (stride + 1)] for y in range(h)}


def _chunks(data):
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        yield pos, n
        pos += 12 + n


def _same_as_jax(path, rate):
    got = load_image(path, rate, device="cpu")
    want = jax_load_image(path, rate)
    assert got.dtype == torch.float32 and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.numpy(), want), f"{path.name} at rate {rate}"


@pytest.mark.parametrize("writer", ["pil", "five_filters"])
@pytest.mark.parametrize("ctype", sorted(PIL_MODES))
def test_png_matches_jax_load_image(tmp_path, ctype, writer):
    """Every 8-bit colour type at an odd size, written by PIL and by a
    writer whose rows take all five filters, decoded and resized bit-equal
    to JAX load_image at rates 1, 0.5, 0.3, 0.25 and 0.123."""
    w, h = 83, 61
    if writer == "pil":
        data = _pil_png(ctype, w, h, seed=ctype)
    else:
        pixels, palette = png_pixels(w, h, ctype, seed=ctype)
        data = encode_png(pixels, ctype, palette)
    channels = image_io.PNG_TYPES[ctype][1]
    if writer == "five_filters":
        assert _filters(data, h, w * channels) == {0, 1, 2, 3, 4}
    path = tmp_path / f"t{ctype}.png"
    path.write_bytes(data)
    assert Image.open(path).mode == PIL_MODES[ctype]
    for rate in RESIZE_RATES:
        _same_as_jax(path, rate)


def test_c_unfilter_matches_numpy_version():
    """Random filtered rows at 1-4 bytes a pixel, every filter type: the C
    unfilter equals its numpy version (and a bad filter type raises in
    both)."""
    rng = np.random.default_rng(3)
    for bpp in (1, 2, 3, 4):
        h, w = 23, 17
        stride = w * bpp
        raw = rng.integers(0, 256, size=(h, stride + 1), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 5, size=h)
        raw[:5, 0] = np.arange(5)
        got = image_io.unfilter(raw.tobytes(), h, stride, bpp)
        want = image_io.unfilter_plain(raw.tobytes(), h, stride, bpp)
        assert np.array_equal(got, want)
        raw[7, 0] = 5
        for fn in (image_io.unfilter, image_io.unfilter_plain):
            with pytest.raises(ValueError, match="row 7 has filter type 5"):
                fn(raw.tobytes(), h, stride, bpp)


def _with_header(data, **fields):
    """``data`` with IHDR fields replaced (CRC recomputed)."""
    names = ("width", "height", "depth", "ctype", "compression", "filter", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = b"IHDR" + struct.pack(">IIBBBBB", *(vals[k] for k in names))
    return data[:12] + body + struct.pack(">I", zlib.crc32(body)) + data[33:]


def test_refused_pngs_raise(tmp_path):
    im16 = io.BytesIO()
    Image.fromarray(np.arange(48, dtype=np.uint16).reshape(6, 8) * 1000).save(im16, "PNG")
    assert Image.open(io.BytesIO(im16.getvalue())).mode.startswith("I")
    im1 = io.BytesIO()
    Image.fromarray(np.eye(8, dtype=bool)).save(im1, "PNG")
    good = encode_png(photo(9, 7, 0), 2)
    bad_crc = bytearray(good)
    bad_crc[40] ^= 0xFF
    cases = {
        "16-bit": im16.getvalue(),
        "1-bit": im1.getvalue(),
        "Adam7-interlaced": _with_header(good, interlace=1),
        "colour type 5": _with_header(good, ctype=5),
        "fails its CRC": bytes(bad_crc),
        "no IEND": good[:-12],
        "not a PNG": b"GIF89a" + good[6:],
    }
    for match, data in cases.items():
        with pytest.raises(ValueError, match=match):
            image_io.decode_png(data)
    path = tmp_path / "x.png"
    path.write_bytes(_with_header(good, interlace=1))
    with pytest.raises(ValueError, match="Adam7"):
        load_image(path, 0.5, device="cpu")


@pytest.mark.parametrize("name", sorted(JPEGS))
def test_jpeg_on_cpu_matches_jax_load_image(name):
    """The committed JPEG fixtures (4:2:0, 4:2:2, 4:4:4, grey, progressive,
    restart markers) through the CPU route: bit-equal to JAX load_image."""
    for rate in RESIZE_RATES:
        _same_as_jax(FIXTURES / name, rate)


def test_jpeg_on_cpu_without_pil_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        load_image(FIXTURES / "jpeg_420.jpg", 0.5, device="cpu")
    # PNG needs no PIL on any device
    assert load_image(FIXTURES / "png_RGB.png", 0.5, device="cpu").shape == (3, 20, 28)


def _patched_sof(data, offset, value):
    out = bytearray(data)
    pos = 2
    while out[pos + 1] not in (0xC0, 0xC1, 0xC2):
        pos += 2 + struct.unpack(">H", out[pos + 2:pos + 4])[0]
    if offset < 0:
        out[pos + 1] = value  # the marker itself
    else:
        out[pos + 4 + offset] = value
    return bytes(out)


def test_refused_jpegs_raise(tmp_path):
    cmyk = io.BytesIO()
    Image.fromarray(photo(16, 16, 0)).convert("CMYK").save(cmyk, "JPEG")
    base = (FIXTURES / "jpeg_444.jpg").read_bytes()
    cases = {
        "CMYK": cmyk.getvalue(),
        "12-bit": _patched_sof(base, 0, 12),
        "lossless": _patched_sof(base, -1, 0xC3),
        "arithmetic": _patched_sof(base, -1, 0xC9),
        "not a JPEG": b"\x00\x00" + base[2:],
    }
    for match, data in cases.items():
        with pytest.raises(ValueError, match=match):
            image_io.jpeg_info(data)
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(cmyk.getvalue())
    with pytest.raises(ValueError, match="CMYK"):
        load_image(path, 1.0, device="cpu")
    path.write_bytes(b"BM" + base[2:])
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        load_image(path, 1.0, device="cpu")


def test_jpeg_info_of_the_fixtures():
    kinds = {name: image_io.jpeg_info((FIXTURES / name).read_bytes()) for name in JPEGS}
    for name, (w, h, _) in JPEGS.items():
        kind, precision, height, width, comps = kinds[name]
        assert (precision, height, width) == (8, h, w)
        assert comps == (1 if name == "jpeg_gray.jpg" else 3)
        assert kind == ("progressive" if name == "jpeg_progressive.jpg" else "baseline")
    assert b"\xff\xdd" in (FIXTURES / "jpeg_restart.jpg").read_bytes()  # restart interval


def test_fixture_archive_equals_pil_here():
    """reference.npz (what the card holds nvJPEG and the CUDA resize to)
    equals PIL's decode and resizes of the committed files on this
    machine, and the port's CPU route reproduces each of them."""
    ref = np.load(FIXTURES / "reference.npz")
    assert len(ref.files) == (len(JPEGS) + len(PNGS)) * (1 + len(RATES))
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 300_000, total
    for name in (*JPEGS, *PNGS):
        with Image.open(FIXTURES / name) as im:
            assert np.array_equal(ref[f"decode/{name}"], np.asarray(im.convert("RGB")))
            got = image_io.load_rgb8(FIXTURES / name, 1.0, "cpu").numpy()
            assert np.array_equal(got, ref[f"decode/{name}"]), name
            for rate in RATES:
                size = image_io.resized_size(im.width, im.height, rate)
                want = np.asarray(im.resize(size).convert("RGB"))
                assert np.array_equal(ref[f"resize{rate}/{name}"], want)
                got = image_io.load_rgb8(FIXTURES / name, rate, "cpu").numpy()
                assert np.array_equal(got, want), (name, rate)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA"])
def test_resize_matches_pil_on_noise(mode):
    """Uniform noise (the hardest case for rounding: every tap matters),
    odd sizes, down and up: pillow_resize + to_rgb equal PIL's
    resize + convert("RGB"). Alpha includes 0 and 255."""
    rng = np.random.default_rng(len(mode))
    ch = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2}[mode]
    for w, h in ((53, 37), (1, 9), (200, 3)):
        a = rng.integers(0, 256, size=(h, w, ch), dtype=np.uint8)
        if ch in (2, 4):
            u = rng.uniform(size=(h, w))
            a[..., -1][u < 0.2], a[..., -1][u > 0.8] = 0, 255
        im = Image.fromarray(a[..., 0] if ch == 1 else a, mode)
        for rate in (0.5, 0.3, 0.25, 0.123, 1.7):
            size = image_io.resized_size(w, h, rate)
            want = np.asarray(im.resize(size).convert("RGB"))
            got = image_io.to_rgb(image_io.pillow_resize(torch.from_numpy(a), mode, size), mode)
            assert np.array_equal(got.numpy(), want), (w, h, rate)


def test_decoders_count_their_calls():
    png, cpu = image_io.decode_png.calls, image_io.decode_jpeg_cpu.calls
    image_io.load_rgb8(FIXTURES / "png_L.png", 1.0, "cpu")
    image_io.load_rgb8(FIXTURES / "jpeg_gray.jpg", 1.0, "cpu")
    assert image_io.decode_png.calls == png + 1 and image_io.decode_jpeg_cpu.calls == cpu + 1
