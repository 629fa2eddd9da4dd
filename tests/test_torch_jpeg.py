"""PyTorch port: the JPEG encoder's plain version (utils/jpeg.py, reached on
the CPU through ops/kernels/jpeg.py::encode_jpeg) byte-equal to the JAX
viewer's ``_encode`` (PIL, libjpeg-turbo) on noise, flat, gradient and
rendered frames at every size and quality the servers and the table
scaling reach; the headers in PIL's marker order; the quantiser against
libjpeg-turbo's reciprocal form; the kernel source's constants against the
plain module's. Inputs come from numpy seeds; nothing here needs a card."""

import io
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from easygaussiansplatting_tpu.viewer.server import _encode
from easygaussiansplatting_tpu_torch.data import example_gaussians
from easygaussiansplatting_tpu_torch.data.fixtures import JPEG_KINDS, JPEG_SIZES, jpeg_frame
from easygaussiansplatting_tpu_torch.ops.kernels.jpeg import encode_jpeg
from easygaussiansplatting_tpu_torch.utils import jpeg
from easygaussiansplatting_tpu_torch.utils.image import frame_u8
from easygaussiansplatting_tpu_torch.viewer.server import SceneRenderer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
QUALITIES = (88, 90, 50, 100)  # the monitor's, the viewer's, the scaling's pivot and its floor


@pytest.fixture(scope="module")
def scene():
    g = example_gaussians()
    return SceneRenderer({k: g[k] for k in ("pws", "rots", "scales", "alphas", "shs")},
                         device="cpu")


def _frame(kind, size, scene):
    h, w = size
    if kind == "render":
        return scene.render(azimuth=0.7, elevation=0.3, width=w, height=h, radius=2.0)
    return jpeg_frame(kind, h, w, seed=h * 1000 + w)


def _pil(frame, quality):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", JPEG_KINDS + ("render",))
@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_plain_encode_equals_the_jax_viewers_encode(scene, size, kind, quality):
    frame = _frame(kind, size, scene)
    want, ctype = _encode(frame, "jpeg", quality)
    assert ctype == "image/jpeg"
    got = encode_jpeg(torch.from_numpy(frame), quality)
    assert got == want


@pytest.mark.parametrize("quality", [1, 5, 10, 24, 25, 49, 51, 75, 99])
def test_plain_encode_equals_pil_at_clamped_and_scaled_tables(quality):
    """Qualities whose tables clamp at 255 (force_baseline) or scale by
    5000 / q and 200 - 2q on either side of 50."""
    frame = jpeg_frame("noise", 40, 56, seed=quality)
    assert encode_jpeg(torch.from_numpy(frame), quality) == _pil(frame, quality)


def test_monitor_frame_equals_pil_at_quality_88(scene):
    """The monitor's path: a float render through frame_u8 and K11's plain
    version at 88, against the JAX monitor's clip, cast and PIL save."""
    img = torch.from_numpy(np.random.default_rng(7).uniform(-0.2, 1.2, (3, 96, 128))
                           .astype(np.float32))
    arr = (np.clip(np.transpose(img.numpy(), (1, 2, 0)), 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(frame_u8(img).numpy(), arr)
    assert encode_jpeg(frame_u8(img), quality=88) == _pil(arr, 88)


def _segments(data):
    """(marker, payload) from SOI up to and including SOS, then the scan's
    length and the two bytes after it."""
    assert data[:2] == b"\xff\xd8"
    out, pos = [(0xD8, b"")], 2
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length
        if marker == 0xDA:
            return out, len(data) - pos - 2, data[-2:]


@pytest.mark.parametrize("quality", [50, 88, 90, 100])
def test_headers_walk_in_pils_marker_order(quality):
    frame = jpeg_frame("gradient", 546, 979)
    got, got_scan, got_end = _segments(encode_jpeg(torch.from_numpy(frame), quality))
    want, want_scan, want_end = _segments(_pil(frame, quality))
    assert [m for m, _ in got] == [0xD8, 0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4, 0xDA]
    assert got == want
    assert (got_scan, got_end) == (want_scan, want_end) and got_end == b"\xff\xd9"
    assert got[1][1] == b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"  # 1.01, density 1:1
    assert got[4][1][6:] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])  # 4:2:0


@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_pil_decodes_the_bytes_as_its_own(kind):
    """Follows from equality, and fails loudly if equality is loosened: PIL's
    decode of the port's bytes is within 0 levels of its decode of its own."""
    frame = jpeg_frame(kind, 136, 244, seed=3)
    got = np.asarray(Image.open(io.BytesIO(encode_jpeg(torch.from_numpy(frame), 90)))
                     .convert("RGB"))
    want = np.asarray(Image.open(io.BytesIO(_pil(frame, 90))).convert("RGB"))
    assert got.shape == (136, 244, 3)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() == 0


def test_dc_category_11_and_stuffed_ff_bytes():
    """Squares of 0 and 255 at quality 100 reach the largest DC difference
    (category 11); noise there gives 0xFF bytes in the scan, each followed
    by a stuffed 0x00. Both equal PIL's bytes."""
    frame = jpeg_frame("checker", 64, 96)
    zz = jpeg.coefficients(torch.from_numpy(frame), 100)
    dc = zz[:, :4, 0].reshape(-1).to(torch.int32)
    assert int((dc[1:] - dc[:-1]).abs().max()).bit_length() == 11
    assert encode_jpeg(torch.from_numpy(frame), 100) == _pil(frame, 100)
    frame = jpeg_frame("noise", 64, 96, seed=11)
    data = encode_jpeg(torch.from_numpy(frame), 100)
    scan = data[len(jpeg.headers(96, 64, 100)):-2]
    ff = [i for i, b in enumerate(scan) if b == 0xFF]
    assert len(ff) > 10 and all(scan[i + 1] == 0 for i in ff)
    assert data == _pil(frame, 100)


def _reciprocal_quantize(x, divisor):
    """libjpeg-turbo jcdctmgr.c: compute_reciprocal and quantize (the C
    form of its SIMD quantiser), for divisors of 2 and more."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    mag = ((np.abs(x) + c) * fq) >> r
    return np.where(x < 0, -mag, mag)


def test_quantiser_equals_libjpeg_turbos_reciprocal_form():
    """(|x| + q/2) // q with the sign restored, as the plain module and K11
    quantise, equals libjpeg-turbo's reciprocal multiply for every divisor
    8 x 1..255 and every coefficient the islow DCT can give."""
    x = np.arange(-2**14, 2**14, dtype=np.int64)
    for entry in range(1, 256):
        q = torch.full((1,), entry, dtype=torch.int64)
        got = jpeg.quantize(torch.from_numpy(x)[:, None], q)[:, 0].numpy()
        assert np.array_equal(got, _reciprocal_quantize(x, 8 * entry)), entry


def test_quality_tables_and_huffman_codes():
    assert jpeg.quality_scaling(50) == 100 and jpeg.quality_scaling(90) == 20
    assert jpeg.quality_scaling(1) == 5000 and jpeg.quality_scaling(0) == 5000
    assert (jpeg.quant_tables(100) == 1).all() and jpeg.quant_tables(1).max() == 255
    assert jpeg.quant_tables(50)[0].tolist() == jpeg.STD_LUMA_Q.tolist()
    codes, lens = jpeg.code_tables()
    assert lens[0, :12].tolist() == [2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9]  # DC luminance
    assert (lens[1, 0x00], codes[1, 0x00]) == (4, 0b1010)  # EOB
    assert (lens[1, 0xF0], codes[1, 0xF0]) == (11, 0b11111111001)  # ZRL
    assert (lens[3, 0x00], lens[3, 0xF0]) == (2, 10)
    assert sorted(jpeg.ZIGZAG.tolist()) == list(range(64))


def test_kernel_source_constants_match_the_plain_module():
    """csrc/jpeg_encode.cu's zigzag order and fixed-point constants are the
    plain module's."""
    src = (ROOT / "easygaussiansplatting_tpu_torch" / "csrc" / "jpeg_encode.cu").read_text()
    zz = re.search(r"kZigzag\[64\] = \{([^}]*)\}", src).group(1)
    assert [int(v) for v in zz.split(",")] == jpeg.ZIGZAG.tolist()
    consts = dict(re.findall(r"(FIX_\w+) = (\d+)", src))
    for name in ("FIX_0_298631336", "FIX_0_390180644", "FIX_0_541196100", "FIX_0_765366865",
                 "FIX_0_899976223", "FIX_1_175875602", "FIX_1_501321110", "FIX_1_847759065",
                 "FIX_1_961570560", "FIX_2_053119869", "FIX_2_562915447", "FIX_3_072711026"):
        assert int(consts[name]) == getattr(jpeg, name)
    (yr, yg, yb, _), (cbr, cbg, cbb, _), (crr, crg, crb, _) = jpeg.YCC_WEIGHTS
    assert [int(consts[k]) for k in ("FIX_Y_R", "FIX_Y_G", "FIX_Y_B")] == [yr, yg, yb]
    assert [int(consts[k]) for k in ("FIX_CB_R", "FIX_CB_G", "FIX_HALF")] == [-cbr, -cbg, cbb]
    assert [int(consts[k]) for k in ("FIX_HALF", "FIX_CR_G", "FIX_CR_B")] == [crr, -crg, -crb]
    assert re.search(r"MAX_BLOCK_BITS = (\d+)", src).group(1) == "1700"
    assert 22 + 63 * (16 + 10) <= 1700  # a block's most bits: DC, then 63 AC tokens


def test_encode_jpeg_refuses_what_it_cannot_encode():
    with pytest.raises(TypeError, match="torch tensor"):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(torch.zeros((8, 8, 3), dtype=torch.float32))
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        encode_jpeg(torch.zeros((8, 8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="1..65535"):
        encode_jpeg(torch.zeros((0, 8, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="unsupported device"):
        encode_jpeg(torch.zeros((8, 8, 3), dtype=torch.uint8, device="meta"))


def test_modules_import_no_pil():
    code = ("import sys; import easygaussiansplatting_tpu_torch.utils.jpeg, "
            "easygaussiansplatting_tpu_torch.ops.kernels.jpeg, "
            "easygaussiansplatting_tpu_torch.viewer.server, "
            "easygaussiansplatting_tpu_torch.viewer.monitor, "
            "easygaussiansplatting_tpu_torch.sh_demo; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'jax')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
