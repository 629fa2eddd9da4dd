"""Photo decode and a Pillow-exact resize, without PIL on the card.

The JAX package's ``load_image`` (easygaussiansplatting_tpu/data/dataset.py)
opens a photo with PIL, resizes it with ``Image.resize`` (BICUBIC for the
photo's modes) and converts it to RGB. The port does the same in three
parts, each chosen by the device the caller asks for, never by what happens
to import:

* **PNG**, on every device: the chunks are parsed here, the image data is
  inflated by ``zlib`` and its rows unfiltered by the C unfilter of
  ``native/png_unfilter.cc`` (:func:`unfilter`; :func:`unfilter_plain` is
  its numpy version, for the tests). 8-bit colour types 0, 2, 3, 4 and 6
  decode to Pillow's modes L, RGB, P, LA and RGBA; other bit depths and
  Adam7 interlacing raise ``ValueError``.
* **JPEG** on a CUDA device: nvJPEG (``csrc/nvjpeg_decode.cpp``, built by
  ``nvcc -lnvjpeg`` into its own library under ``build/nvjpeg/`` at first
  use, apart from the kernel library), decoding to interleaved RGB in a
  buffer torch allocates, on torch's current stream. Its IDCT and chroma
  upsampling are not libjpeg's, so its output differs from PIL's by a few
  levels (:data:`NVJPEG_MAX_ABS`, :data:`NVJPEG_MEAN_ABS`). Grayscale comes out
  replicated to RGB. On the CPU, and only there, PIL decodes JPEG (imported
  inside that branch). On both, CMYK, YCCK, 12-bit, lossless, arithmetic
  and hierarchical JPEGs raise ``ValueError`` (:func:`jpeg_info`).
* **Resize** (:func:`pillow_resize`): a port of Pillow's separable resample
  (``Resample.c``: ``precompute_coeffs``, ``normalize_coeffs_8bpc``), bicubic
  with a = -0.5. Coefficients are computed in float64 on the host and
  rounded to int32 with 22 fractional bits; the horizontal pass runs over
  all rows, its result is rounded and clipped to uint8, then the vertical
  pass runs. The passes are torch integer ops, so they run on the device
  where the decoded image lies, and they are bit-equal to PIL. Pillow's
  mode rules hold: P resizes by NEAREST, LA and RGBA resize premultiplied.

EXIF orientation is not applied, as in JAX. Each decoder counts its calls
(``decode_png.calls``, ``decode_jpeg_cuda.calls``, ``decode_jpeg_cpu.calls``).
"""

import ctypes
import functools
import io
import math
import os
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data import native_loader
from easygaussiansplatting_tpu_torch.utils.device import resolve_device

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (Pillow mode, channels), 8 bits a channel
PNG_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}

# nvJPEG against PIL (libjpeg-turbo) on the committed JPEG fixtures, in
# 8-bit levels over all pixels and channels: measured at most 23 and 0.98
# on an NVIDIA H100 80GB HBM3 (700 W, CUDA 12.9's nvJPEG); the limits leave
# room above that and still refuse make_io_fixtures.planted_faults
NVJPEG_MAX_ABS = 32
NVJPEG_MEAN_ABS = 1.25

# Pillow's Resample.c: fixed-point bits of the 8-bit passes, and its bicubic
PRECISION_BITS = 32 - 8 - 2
BICUBIC_A = -0.5
BICUBIC_SUPPORT = 2.0


# ---------------------------------------------------------------- PNG


def unfilter(raw, height, stride, bpp):
    """Undo the PNG row filters of inflated image data ``raw`` (height rows
    of a filter byte and ``stride`` bytes, ``bpp`` bytes a pixel) with the C
    unfilter; returns a uint8 array [height, stride]."""
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, stride), np.uint8)
    bad = native_loader.library().egs_png_unfilter(src.ctypes.data, out.ctypes.data,
                                                   height, stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {src[(bad - 1) * (stride + 1)]}, "
                         "not 0-4")
    return out


def unfilter_plain(raw, height, stride, bpp):
    """numpy version of :func:`unfilter`: the same rows, a pixel at a time
    along each row for the filters that depend on the byte before."""
    src = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height + 1, stride + bpp), np.int32)  # a zero row above, bpp zeros left
    for y in range(height):
        kind, row = int(src[y, 0]), src[y, 1:].astype(np.int32)
        up = out[y, bpp:]
        if kind == 0:
            out[y + 1, bpp:] = row
        elif kind == 2:
            out[y + 1, bpp:] = (row + up) & 255
        elif kind in (1, 3, 4):
            for i in range(0, stride, bpp):
                a = out[y + 1, i:i + bpp]
                b = out[y, i + bpp:i + 2 * bpp]
                c = out[y, i:i + bpp]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                out[y + 1, i + bpp:i + 2 * bpp] = (row[i:i + bpp] + pred) & 255
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not 0-4")
    return out[1:, bpp:].astype(np.uint8)


def decode_png(data):
    """PNG bytes -> (uint8 array [H,W,C], Pillow mode). Mode P comes out
    already looked up in its palette ([H,W,3]); it keeps the mode, because
    Pillow resizes P by NEAREST."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG {tag.decode('latin-1')} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG {tag.decode('latin-1')} chunk fails its CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in PNG_TYPES:
        raise ValueError(f"PNG colour type {ctype} is not one of {sorted(PNG_TYPES)}")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG not supported: only 8 bits a channel are")
    if interlace:
        raise ValueError("Adam7-interlaced PNG not supported")
    mode, channels = PNG_TYPES[ctype]
    stride = width * channels
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"truncated PNG image data: {len(raw)} of {height * (stride + 1)} bytes")
    pixels = unfilter(raw[:height * (stride + 1)], height, stride, channels)
    pixels = pixels.reshape(height, width, channels)
    if mode == "P":
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        full = np.zeros((256, 3), np.uint8)  # entries past the palette read as black
        full[:len(palette)] = palette[:256]
        pixels = full[pixels[..., 0]]
    decode_png.calls += 1
    return pixels, mode


decode_png.calls = 0


# ---------------------------------------------------------------- JPEG

# SOF markers: 0xC0 baseline, 0xC1 extended, 0xC2 progressive (decoded);
# the rest raise
_SOF_KINDS = {0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
              0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
              0xC7: "hierarchical lossless", 0xC9: "arithmetic", 0xCA: "arithmetic progressive",
              0xCB: "arithmetic lossless", 0xCD: "hierarchical arithmetic",
              0xCE: "hierarchical arithmetic progressive",
              0xCF: "hierarchical arithmetic lossless"}


def jpeg_info(data):
    """(kind, precision, height, width, components) from a JPEG's frame
    header; raises ValueError for what the port does not decode: 12-bit,
    CMYK and YCCK (four components), and every kind but baseline, extended
    sequential and progressive."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos, adobe = 2, None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        if marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]  # colour transform: 0 none/CMYK, 1 YCbCr, 2 YCCK
        if marker in _SOF_KINDS:
            kind = _SOF_KINDS[marker]
            precision, height, width, comps = struct.unpack(">BHHB", seg[:6])
            if marker not in (0xC0, 0xC1, 0xC2):
                raise ValueError(f"{kind} JPEG not supported")
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG not supported: only 8-bit is")
            if comps == 4:
                raise ValueError(f"{'YCCK' if adobe == 2 else 'CMYK'} JPEG not supported")
            if comps not in (1, 3):
                raise ValueError(f"JPEG with {comps} components not supported")
            return kind, precision, height, width, comps
        pos += 2 + length
    raise ValueError("corrupt JPEG: no frame header")


def decode_jpeg_cpu(data):
    """JPEG bytes -> (uint8 array [H,W,C], Pillow mode L or RGB), decoded by
    PIL: the CPU device's JPEG route, and the only place the port imports
    PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding a JPEG on the CPU needs PIL (Pillow), which cannot be "
                          "imported; on a CUDA device nvJPEG decodes it") from e
    with Image.open(io.BytesIO(data)) as im:
        if im.mode not in ("L", "RGB"):
            raise ValueError(f"JPEG of mode {im.mode} not supported")
        mode, pixels = im.mode, np.array(im)
    decode_jpeg_cpu.calls += 1
    return pixels.reshape(pixels.shape[0], pixels.shape[1], -1), mode


decode_jpeg_cpu.calls = 0

NVJPEG_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "nvjpeg_decode.cpp"
NVJPEG_BUILD_DIR = native_loader.ROOT / "build" / "nvjpeg"
NVJPEG_LIB_NAME = "libegs_nvjpeg.so"
# nvjpegStatus_t values; egs_nvjpeg_* return a CUDA error as 1000 + cudaError_t
NVJPEG_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
                 4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
                 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR", 9: "IMPLEMENTATION_NOT_SUPPORTED",
                 10: "INCOMPLETE_BITSTREAM"}


class NvjpegError(RuntimeError):
    pass


def nvjpeg_toolkit():
    """(nvcc, header, library directory) of the CUDA toolkit's nvJPEG;
    raises NvjpegError naming ``nvjpeg.h`` or ``libnvjpeg.so`` when either
    is missing."""
    from easygaussiansplatting_tpu_torch.ops.kernels._build import nvcc_path

    nvcc = nvcc_path()
    home = Path(nvcc).resolve().parents[1]
    header = home / "include" / "nvjpeg.h"
    libdirs = [d for d in (home / "lib64", *sorted(home.glob("targets/*/lib")))
               if any(d.glob("libnvjpeg.so*"))]
    if not header.is_file():
        raise NvjpegError(f"nvjpeg.h not found at {header}: the CUDA toolkit's nvJPEG is needed "
                          "to decode JPEG on the card")
    if not libdirs:
        raise NvjpegError(f"libnvjpeg.so not found under {home}/lib64 or {home}/targets/*/lib: "
                          "the CUDA toolkit's nvJPEG is needed to decode JPEG on the card")
    return nvcc, header, libdirs[0]


def build_nvjpeg(force=False):
    """Compile csrc/nvjpeg_decode.cpp with nvcc against libnvjpeg into
    NVJPEG_BUILD_DIR (through a per-process temporary file and os.replace),
    unless a library newer than the source is there. Returns its path."""
    lib = NVJPEG_BUILD_DIR / NVJPEG_LIB_NAME
    if not force and native_loader.fresh(lib, (NVJPEG_SOURCE,)):
        return lib
    nvcc, _, libdir = nvjpeg_toolkit()
    NVJPEG_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = NVJPEG_BUILD_DIR / f"{NVJPEG_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(NVJPEG_SOURCE), "-L", str(libdir), "-lnvjpeg", "-Xlinker", f"-rpath={libdir}"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NvjpegError(f"nvJPEG decoder build failed:\n$ {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def nvjpeg_library():
    lib = ctypes.CDLL(str(build_nvjpeg()))
    lib.egs_nvjpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.egs_nvjpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.egs_nvjpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.egs_nvjpeg_encoded.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
                                       ctypes.c_void_p]
    for fn in (lib.egs_nvjpeg_info, lib.egs_nvjpeg_decode, lib.egs_nvjpeg_encode,
               lib.egs_nvjpeg_encoded):
        fn.restype = ctypes.c_int
    return lib


def _nvjpeg_check(code, what):
    if code >= 1000:
        raise NvjpegError(f"{what}: CUDA error {code - 1000}")
    if code:
        raise NvjpegError(f"{what}: NVJPEG_STATUS_{NVJPEG_STATUS.get(code, code)}")


def decode_jpeg_cuda(data, device):
    """JPEG bytes -> uint8 tensor [H,W,3] on the CUDA ``device``, decoded by
    nvJPEG on torch's current stream into a tensor torch allocates. The C
    side waits for its stream before it returns, so the nvJPEG state and
    ``data`` are free again when this returns."""
    lib = nvjpeg_library()
    info = (ctypes.c_int * 4)()
    _nvjpeg_check(lib.egs_nvjpeg_info(data, len(data), info), "nvjpegGetImageInfo")
    _, _, width, height = info
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _nvjpeg_check(lib.egs_nvjpeg_decode(data, len(data), out.data_ptr(), width * 3, stream),
                      "nvjpegDecode")
    decode_jpeg_cuda.calls += 1
    return out


decode_jpeg_cuda.calls = 0


def nvjpeg_encode(rgb, quality, fetch=True):
    """nvJPEG's encoder on a contiguous CUDA [H,W,3] uint8 frame (baseline
    4:2:0 at ``quality``, on torch's current stream): the JPEG's bytes, or
    with ``fetch=False`` nothing (the encode is only queued). The port
    encodes with K11 (ops/kernels/jpeg.py), byte-equal to PIL; this is the
    yardstick chip_smoke.py times beside it, and its bytes are not PIL's."""
    lib = nvjpeg_library()
    height, width, _ = rgb.shape
    stream = torch.cuda.current_stream(rgb.device).cuda_stream
    _nvjpeg_check(lib.egs_nvjpeg_encode(rgb.data_ptr(), width * 3, width, height, int(quality),
                                        stream), "nvjpegEncodeImage")
    if not fetch:
        return None
    length = ctypes.c_size_t()
    _nvjpeg_check(lib.egs_nvjpeg_encoded(None, ctypes.byref(length), stream),
                  "nvjpegEncodeRetrieveBitstream")
    out = ctypes.create_string_buffer(length.value)
    _nvjpeg_check(lib.egs_nvjpeg_encoded(out, ctypes.byref(length), stream),
                  "nvjpegEncodeRetrieveBitstream")
    return out.raw[:length.value]


# ---------------------------------------------------------------- resize


def _bicubic(x):
    """Pillow's bicubic_filter, a = -0.5, in its order of operations."""
    x = np.abs(x)
    a = BICUBIC_A
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def resize_coeffs(in_size, out_size):
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for one axis:
    (first input index [out] int64, int32 coefficients [out, ksize]).
    Coefficients past an output's window are 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int) truncates, then the window is clamped to the image
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    count = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < count[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # Pillow sums the taps in order
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    one = float(1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, kk.astype(np.int32)


def _bicubic_pass(img, dim, out_size):
    """One Pillow 8-bit pass along ``dim`` of an int32 [H,W,C] tensor:
    1 << 21 plus the taps' products, shifted down 22 bits and clipped."""
    in_size = img.shape[dim]
    xmin, kk = resize_coeffs(in_size, out_size)
    idx = torch.from_numpy(np.minimum(xmin[:, None] + np.arange(kk.shape[1]), in_size - 1))
    idx = idx.to(img.device)
    kk = torch.from_numpy(kk).to(img.device)
    shape = [1, 1, 1]
    shape[dim] = out_size
    acc = torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int32, device=img.device)
    for t in range(kk.shape[1]):
        acc = acc + img.index_select(dim, idx[:, t]) * kk[:, t].view(shape)
    return torch.clamp(acc >> PRECISION_BITS, 0, 255)


def resize_bicubic(img, size):
    """Pillow's BICUBIC resize of a uint8 tensor [H,W,C] to ``size`` = (width,
    height): the horizontal pass first (where the width changes), then the
    vertical (where the height does)."""
    width, height = size
    out = img.to(torch.int32)
    if width != img.shape[1]:
        out = _bicubic_pass(out, 1, width)
    if height != img.shape[0]:
        out = _bicubic_pass(out, 0, height)
    return out.to(torch.uint8)


def _nearest_index(in_size, out_size):
    """Pillow's NEAREST source index per output position: a position
    advanced by repeated addition of in/out from half a step, truncated;
    (index, in range)."""
    step = float(in_size) / out_size
    pos = np.add.accumulate(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    idx = np.where(pos < 0, -1, np.trunc(pos)).astype(np.int64)
    ok = (idx >= 0) & (idx < in_size)
    return np.where(ok, idx, 0), ok


def resize_nearest(img, size):
    """Pillow's NEAREST resize of a uint8 tensor [H,W,C] (out-of-range
    positions black, as Pillow leaves them)."""
    width, height = size
    xi, xok = _nearest_index(img.shape[1], width)
    yi, yok = _nearest_index(img.shape[0], height)
    out = img.index_select(0, torch.from_numpy(yi).to(img.device))
    out = out.index_select(1, torch.from_numpy(xi).to(img.device))
    keep = torch.from_numpy(yok[:, None] & xok[None, :]).to(img.device)
    return torch.where(keep[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def _muldiv255(a, b):
    """Pillow's MULDIV255: a * b / 255, rounded, in integers."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def premultiply(img):
    """Pillow's RGBA -> RGBa (and LA -> La): every colour channel times
    alpha / 255 (MULDIV255); uint8 [H,W,C], alpha last."""
    x = img.to(torch.int32)
    alpha = x[..., -1:]
    return torch.cat([_muldiv255(x[..., :-1], alpha), alpha], dim=-1).to(torch.uint8)


def unpremultiply(img):
    """Pillow's RGBa -> RGBA (and La -> LA): colour * 255 / alpha, clipped,
    where alpha is neither 0 nor 255; there the colour is kept."""
    x = img.to(torch.int32)
    alpha = x[..., -1:]
    div = torch.clamp(255 * x[..., :-1] // torch.clamp(alpha, min=1), max=255)
    keep = (alpha == 0) | (alpha == 255)
    return torch.cat([torch.where(keep, x[..., :-1], div), alpha], dim=-1).to(torch.uint8)


def pillow_resize(img, mode, size):
    """``Image.resize(size)`` with its default filter for an image of Pillow
    mode ``mode`` held as a uint8 tensor [H,W,C] (P already looked up in its
    palette): the image itself at its own size, NEAREST for P, BICUBIC with
    premultiplied alpha for LA and RGBA, BICUBIC otherwise."""
    if tuple(size) == (img.shape[1], img.shape[0]):
        return img
    if mode == "P":
        return resize_nearest(img, size)
    if mode in ("LA", "RGBA"):
        return unpremultiply(resize_bicubic(premultiply(img), size))
    return resize_bicubic(img, size)


def to_rgb(img, mode):
    """``convert("RGB")``: L and LA replicate their grey, RGBA and LA drop
    alpha; RGB and P (already looked up) are RGB."""
    if mode in ("L", "LA"):
        return img[..., :1].expand(-1, -1, 3).contiguous()
    return img[..., :3].contiguous()


def resized_size(width, height, resize_rate):
    """The JAX loader's output size: (max(1, round(w*rate)), max(1, round(h*rate)))."""
    return max(1, round(width * resize_rate)), max(1, round(height * resize_rate))


def decode_file(path, device="cuda"):
    """A PNG or JPEG file -> (uint8 tensor [H,W,C] on ``device``, Pillow
    mode). JPEG by nvJPEG on a CUDA device and by PIL on the CPU; PNG by the
    port's own decoder on both."""
    dev = resolve_device(device)
    data = Path(path).read_bytes()
    if data.startswith(PNG_SIGNATURE):
        pixels, mode = decode_png(data)
        return torch.from_numpy(pixels).to(dev), mode
    if data[:2] == b"\xff\xd8":
        jpeg_info(data)
        if dev.type == "cuda":
            return decode_jpeg_cuda(data, dev), "RGB"
        pixels, mode = decode_jpeg_cpu(data)
        return torch.from_numpy(pixels), mode
    raise ValueError(f"{path}: not a PNG or JPEG file (the port decodes those two)")


def load_rgb8(path, resize_rate=1.0, device="cuda"):
    """A PNG or JPEG photo -> uint8 tensor [H,W,3] on ``device``, resized
    by ``resize_rate`` as the JAX loader resizes it (Image.resize, then
    convert("RGB")). The decoder is chosen by ``device``: JPEG by nvJPEG on
    a CUDA device and by PIL on the CPU; PNG by the port's own decoder on
    both."""
    img, mode = decode_file(path, device)
    if resize_rate != 1:
        img = pillow_resize(img, mode, resized_size(img.shape[1], img.shape[0], resize_rate))
    return to_rgb(img, mode)
