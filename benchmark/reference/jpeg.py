"""Baseline JPEG encoding, byte-equal to libjpeg(-turbo) at its defaults.

A frozen copy of the program's plain encoder (``utils/jpeg.py`` of the
PyTorch package), kept with the benchmark so that the yardstick a served
frame is judged by cannot move with the program. What follows is that
file's own description.

The plain PyTorch version of K11 (``csrc/jpeg_encode.cu``, wrapper
``ops/kernels/jpeg.py``), which encodes the frames the JAX package hands to
PIL's ``Image.save(format="JPEG", quality=q)``: 4:2:0 chroma subsampling,
the integer DCT, the standard Huffman tables, a JFIF 1.01 APP0 with density
1:1, no restart interval. Every stage is libjpeg's public routine in
integer arithmetic, so the bytes equal PIL's:

* headers: ``jcparam.c`` (``jpeg_quality_scaling``, ``jpeg_add_quant_table``
  with ``force_baseline``) and ``jcmarker.c``'s marker order;
* colour: ``jccolor.c`` ``rgb_ycc_convert`` (16-bit fixed point);
* edges and downsampling: ``jcsample.c`` ``expand_right_edge`` and
  ``h2v2_downsample`` (bias 1, 2, 1, 2 along a row), the bottom rows
  replicated as ``jcprepct.c`` does;
* DCT: ``jfdctint.c`` ``jpeg_fdct_islow``;
* quantising: ``jcdctmgr.c`` (divisor 8 x the table entry, rounded half
  away from zero), coefficients kept in zigzag order;
* dummy blocks: ``jccoefct.c`` ``compress_data`` (a partial MCU's dummy
  blocks carry the DC of the block before them, AC zero);
* entropy coding: ``jchuff.c`` ``encode_one_block`` with 1-bit padding and
  0x00 stuffed after every 0xFF.

Vectorised over blocks and coefficients (no Python loop over either), in
torch on the input's device; only the finished scan goes to the host. No
PIL: the tests hold these bytes equal to PIL's.
"""

import functools
import struct

import numpy as np
import torch

# jpeg_natural_order: the natural (row-major) index of zigzag position k
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl, natural order
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_Q = np.full(64, 99, np.int64)
STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# jstdhuff.c: (bits[1..16], values) of DC luminance, AC luminance,
# DC chrominance, AC chrominance
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
HUFF_TABLES = (
    (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA_VALS),
    (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_VALS),
)

# jccolor.c: 16-bit fixed point, FIX(x) = (x * 2^16 + 0.5) truncated
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
CBCR_OFFSET = 128 << SCALEBITS


def _fix16(x):
    return int(x * (1 << SCALEBITS) + 0.5)


# rows Y, Cb, Cr: (R, G, B) weights and the constant each sum starts from
YCC_WEIGHTS = (
    (_fix16(0.29900), _fix16(0.58700), _fix16(0.11400), ONE_HALF),
    (-_fix16(0.16874), -_fix16(0.33126), _fix16(0.50000), CBCR_OFFSET + ONE_HALF - 1),
    (_fix16(0.50000), -_fix16(0.41869), -_fix16(0.08131), CBCR_OFFSET + ONE_HALF - 1),
)

# jfdctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)
CONST_BITS = 13
PASS1_BITS = 2
FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172

BLOCKS_PER_MCU = 6  # Y00, Y01, Y10, Y11, Cb, Cr


def quality_scaling(quality):
    """jcparam.c jpeg_quality_scaling: quality 1..100 -> percentage."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - quality * 2


def quant_tables(quality):
    """jcparam.c jpeg_set_quality(quality, force_baseline=TRUE): the
    luminance and chrominance tables, [2, 64] int64 in natural order."""
    scale = quality_scaling(quality)
    tabs = (np.stack([STD_LUMA_Q, STD_CHROMA_Q]) * scale + 50) // 100
    return np.clip(tabs, 1, 255)


def huffman_codes(bits, vals):
    """jchuff.c jpeg_make_c_derived_tbl: (codes[256], lengths[256]) int64,
    length 0 for a symbol the table lacks."""
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = code
            lens[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


@functools.lru_cache(maxsize=None)
def code_tables():
    """The four tables (DC0, AC0, DC1, AC1) as one [2, 4, 256] int64 array:
    codes, then lengths."""
    out = np.zeros((2, 4, 256), np.int64)
    for t, (bits, vals) in enumerate(HUFF_TABLES):
        out[0, t], out[1, t] = huffman_codes(bits, vals)
    return out


def _marker(code, payload):
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


@functools.lru_cache(maxsize=64)
def headers(width, height, quality):
    """Every byte before the entropy-coded scan, as jcmarker.c writes them:
    SOI, APP0 (JFIF 1.01, units 0, density 1:1), DQT 0 and DQT 1, SOF0 (Y
    2x2, Cb and Cr 1x1), DHT DC0, AC0, DC1, AC1, SOS."""
    q = quant_tables(quality)
    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(2):
        out.append(_marker(0xDB, bytes([t]) + bytes(q[t][ZIGZAG].astype(np.uint8))))
    out.append(_marker(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, (bits, vals) in zip((0x00, 0x10, 0x01, 0x11), HUFF_TABLES):
        out.append(_marker(0xC4, bytes([cls_id]) + bits + vals))
    out.append(_marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


EOI = b"\xff\xd9"


def mcu_grid(width, height):
    """(MCU rows, MCU columns) of a frame: 16x16 pixels an MCU."""
    return -(-height // 16), -(-width // 16)


# ---------------------------------------------------------------- stages


def rgb_to_ycc(rgb):
    """jccolor.c rgb_ycc_convert: [..., 3] uint8 -> [3, ...] int32 (Y, Cb, Cr)."""
    c = rgb.to(torch.int32)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([(wr * r + wg * g + wb * b + k) >> SCALEBITS
                        for wr, wg, wb, k in YCC_WEIGHTS])


def planes(rgb):
    """The component planes the DCT reads, edges filled as libjpeg fills
    them: Y [16*mr, 16*mc] and Cb, Cr [8*mr, 8*mc] (int32, 0..255).

    Y: columns past the frame repeat its last column (expand_right_edge),
    rows past it its last row. Chroma: the full-resolution rows are padded
    to an even count and the columns to 16*mc by repetition, each 2x2 cell
    averaged with bias 1, 2, 1, 2 along the row (h2v2_downsample), and the
    chroma rows past ceil(H/2) repeat the last chroma row (jcprepct.c)."""
    h, w, _ = rgb.shape
    mr, mc = mcu_grid(w, h)
    dev = rgb.device
    ycc = rgb_to_ycc(rgb)
    cols = torch.arange(16 * mc, device=dev).clamp(max=w - 1)
    rows = torch.arange(16 * mr, device=dev).clamp(max=h - 1)
    y = ycc[0][rows][:, cols]
    hc = -(-h // 2)  # chroma rows from the frame
    crow = torch.arange(8 * mr, device=dev).clamp(max=hc - 1)
    full = torch.stack([2 * crow, 2 * crow + 1], 1).clamp(max=h - 1)  # [8mr, 2]
    c = ycc[1:][:, full][:, :, :, cols]  # [2, 8mr, 2, 16mc]
    c = c.reshape(2, 8 * mr, 2, 8 * mc, 2).sum(dim=(2, 4))
    bias = 1 + (torch.arange(8 * mc, device=dev, dtype=torch.int32) & 1)
    return y, (c + bias) >> 2


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, shift_even, descale_bits):
    """One pass of jpeg_fdct_islow along the last axis of ``d`` (8 long).
    ``shift_even``: pass 1 shifts the even terms 0 and 4 left by
    PASS1_BITS, pass 2 descales them by PASS1_BITS."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if shift_even:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, descale_bits)
    out[6] = _descale(z1 - tmp12 * FIX_1_847759065, descale_bits)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    out[7] = _descale(tmp4 + z1 + z3, descale_bits)
    out[5] = _descale(tmp5 + z2 + z4, descale_bits)
    out[3] = _descale(tmp6 + z2 + z3, descale_bits)
    out[1] = _descale(tmp7 + z1 + z4, descale_bits)
    return torch.stack(out, dim=-1)


def fdct_islow(blocks):
    """jfdctint.c jpeg_fdct_islow on [..., 8, 8] int32 samples (already
    minus 128); the output carries the factor 8 of the unscaled DCT."""
    rows = _fdct_1d(blocks, True, CONST_BITS - PASS1_BITS)
    return _fdct_1d(rows.transpose(-1, -2), False, CONST_BITS + PASS1_BITS).transpose(-1, -2)


def quantize(coef, table):
    """jcdctmgr.c's quantiser for the islow DCT: divide by 8 x the table
    entry, rounded half away from zero. ``coef`` [..., 64] natural order,
    ``table`` [64]."""
    q = 8 * table
    mag = torch.div(coef.abs() + (q >> 1), q, rounding_mode="floor")
    return torch.where(coef < 0, -mag, mag)


def coefficients(rgb, quality):
    """Stages up to quantising: [H, W, 3] uint8 -> int16 [n_mcu, 6, 64] in
    zigzag order, MCUs in raster order, blocks Y00, Y01, Y10, Y11, Cb, Cr,
    the dummy blocks of a partial MCU filled as compress_data fills them.
    What K11's first kernel writes."""
    h, w, _ = rgb.shape
    mr, mc = mcu_grid(w, h)
    dev = rgb.device
    y, c = planes(rgb)
    yb = y.reshape(mr, 2, 8, mc, 2, 8).permute(0, 3, 1, 4, 2, 5).reshape(mr, mc, 4, 8, 8)
    cb = c.reshape(2, mr, 8, mc, 8).permute(1, 3, 0, 2, 4)
    blocks = torch.cat([yb, cb], dim=2).reshape(mr * mc, BLOCKS_PER_MCU, 64) - 128
    tabs = torch.as_tensor(quant_tables(quality), dtype=torch.int32, device=dev)
    coef = fdct_islow(blocks.reshape(-1, BLOCKS_PER_MCU, 8, 8)).reshape(-1, BLOCKS_PER_MCU, 64)
    qt = tabs[torch.tensor([0, 0, 0, 0, 1, 1], device=dev)]  # [6, 64]
    zz = quantize(coef, qt)[:, :, torch.as_tensor(ZIGZAG, device=dev)]
    # dummy blocks: a Y column past ceil(W/8) blocks, a Y row past ceil(H/8)
    zz = zz.reshape(mr, mc, BLOCKS_PER_MCU, 64)
    if (-(-w // 8)) % 2:  # Y01 and Y11 of the last MCU column
        zz[:, -1, 1] = 0
        zz[:, -1, 1, 0] = zz[:, -1, 0, 0]
        zz[:, -1, 3] = 0
        zz[:, -1, 3, 0] = zz[:, -1, 2, 0]
    if (-(-h // 8)) % 2:  # Y10 and Y11 of the last MCU row take Y01's DC
        zz[-1, :, 2:4] = 0
        zz[-1, :, 2:4, 0] = zz[-1, :, 1:2, 0]
    return zz.reshape(mr * mc, BLOCKS_PER_MCU, 64).to(torch.int16)


def _nbits(v):
    """Bits of |v| (0 for 0), for |v| < 2^15, as int64."""
    return torch.frexp(v.abs().to(torch.float32))[1].to(torch.int64)


def tokens(zz):
    """encode_one_block's output per coefficient slot: ``zz`` int16 [n_mcu,
    6, 64] -> (value, length) int64 [n_mcu * 6, 64] in scan order. Slot 0
    holds the DC code and magnitude; slot k >= 1 a nonzero AC's ZRLs, code
    and magnitude; slot 63 the EOB when the block ends in zeros. Bits are
    MSB-first within a value."""
    n_mcu = zz.shape[0]
    dev = zz.device
    ct = torch.as_tensor(code_tables(), device=dev)
    codes, lens = ct[0], ct[1]
    z = zz.to(torch.int64)
    # DC differences per component, in scan order
    dc = z[:, :, 0]
    y_dc = dc[:, :4].reshape(-1)
    y_diff = (y_dc - torch.cat([y_dc.new_zeros(1), y_dc[:-1]])).reshape(n_mcu, 4)
    c_diff = dc[:, 4:] - torch.cat([dc.new_zeros(1, 2), dc[:-1, 4:]])
    diff = torch.cat([y_diff, c_diff], dim=1)  # [n_mcu, 6]
    z = z.clone()
    z[:, :, 0] = diff
    z = z.reshape(-1, 64)
    nb = _nbits(z)
    mag = (z - (z < 0).to(torch.int64)) & ((1 << nb) - 1)
    chroma = torch.tensor([0, 0, 0, 0, 1, 1], device=dev).repeat(n_mcu)[:, None]  # [B, 1]
    dc_t, ac_t = 2 * chroma, 2 * chroma + 1
    # runs of zeros before each AC: k - (last nonzero AC position below k) - 1
    k = torch.arange(64, device=dev)
    nz = z != 0
    last = torch.cummax(torch.where(nz, k, 0), dim=1).values
    prev = torch.cat([last.new_zeros(last.shape[0], 1), last[:, :-1]], dim=1)
    run = k - prev - 1
    sym = ((run & 15) << 4) | nb
    n_zrl = run >> 4
    zrl_code, zrl_len = codes[ac_t, 0xF0], lens[ac_t, 0xF0]
    rep = torch.zeros_like(run)
    for i in range(3):  # up to three ZRLs (runs of up to 62)
        rep = torch.where(n_zrl > i, (rep << zrl_len) | zrl_code, rep)
    rep_len = n_zrl * zrl_len
    ac_len = lens[ac_t, sym]
    val = (((rep << ac_len) | codes[ac_t, sym]) << nb) | mag
    length = torch.where(nz, rep_len + ac_len + nb, 0)
    val = torch.where(nz, val, 0)
    # slot 0: the DC category's code and the magnitude
    dc_len = lens[dc_t[:, 0], nb[:, 0]]
    val[:, 0] = (codes[dc_t[:, 0], nb[:, 0]] << nb[:, 0]) | mag[:, 0]
    length[:, 0] = dc_len + nb[:, 0]
    # slot 63: EOB after the last nonzero AC, unless that is position 63
    eob = ~nz[:, 63]
    val[:, 63] = torch.where(eob, codes[ac_t[:, 0], 0], val[:, 63])
    length[:, 63] = torch.where(eob, lens[ac_t[:, 0], 0], length[:, 63])
    return val, length


def pack_bits(val, length):
    """Concatenate (value, length) tokens MSB-first: [total bytes] uint8 on
    the tokens' device, the last byte padded with 1-bits (flush_bits). A
    token is at most 59 bits (three ZRLs of 11, a 16-bit code, 10 magnitude
    bits), so it spans at most two 64-bit words."""
    val, length = val.reshape(-1), length.reshape(-1)
    keep = length > 0
    val, length = val[keep], length[keep]
    end = torch.cumsum(length, 0)
    total = int(end[-1])  # every block has a DC token
    start = end - length
    n_words = -(-total // 64) + 1
    words = torch.zeros(n_words, dtype=torch.int64, device=val.device)
    w, s = start >> 6, start & 63
    e = s + length  # end bit within word w, 1..123
    first = torch.where(e <= 64, val << (64 - e).clamp(min=0), val >> (e - 64).clamp(min=0))
    spill = e > 64
    lo = e - 64  # bits of the token in word w + 1
    second = (val & ((1 << lo.clamp(min=0)) - 1)) << (64 - lo).clamp(max=63)
    # bits are disjoint, so a sum is an OR (int64 wraps as uint64)
    words.index_add_(0, w, first)
    words.index_add_(0, (w + 1)[spill], second[spill])
    n_bytes = -(-total // 8)
    # big-endian bytes of each word
    shifts = torch.arange(56, -1, -8, device=val.device)
    out = ((words[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)[:n_bytes].clone()
    if total % 8:
        out[-1] |= 0xFF >> (total % 8)
    return out


def stuff_bytes(scan):
    """Insert 0x00 after every 0xFF of an entropy-coded scan (uint8 [n])."""
    ff = (scan == 0xFF).to(torch.int64)
    pos = torch.arange(len(scan), device=scan.device) + torch.cumsum(ff, 0) - ff
    out = torch.zeros(len(scan) + int(ff.sum()), dtype=torch.uint8, device=scan.device)
    out[pos] = scan
    return out


def entropy_code(zz):
    """The stuffed entropy-coded scan of ``coefficients``' output, as bytes."""
    val, length = tokens(zz)
    return stuff_bytes(pack_bits(val, length)).cpu().numpy().tobytes()


def check_frame(rgb):
    """Raise unless ``rgb`` is an [H, W, 3] uint8 tensor of a size JPEG
    can hold."""
    if not isinstance(rgb, torch.Tensor):
        raise TypeError(f"expected a torch tensor, got {type(rgb).__name__}")
    if rgb.dtype != torch.uint8 or rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} {tuple(rgb.shape)}")
    h, w, _ = rgb.shape
    if not (1 <= w <= 65535 and 1 <= h <= 65535):
        raise ValueError(f"JPEG frame size must be 1..65535, got {w}x{h}")


def encode_jpeg_plain(rgb, quality=90):
    """Plain version of K11: [H, W, 3] uint8 tensor -> the bytes of PIL's
    ``Image.save(format="JPEG", quality=quality)``, computed on the
    tensor's device."""
    check_frame(rgb)
    h, w, _ = rgb.shape
    return headers(w, h, quality) + entropy_code(coefficients(rgb, quality)) + EOI
