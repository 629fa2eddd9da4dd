"""K11: baseline JPEG encoding of an RGB frame, byte-equal to PIL's.

Replaces no Pallas kernel: the JAX package encodes its served frames on the
host with PIL (``viewer/server.py`` ``_encode``, ``viewer/monitor.py``, the
root ``sh_demo.py``); the port encodes them on the card where they were
rendered, so only the compressed bytes cross to the host. The kernels are
``csrc/jpeg_encode.cu``; the plain version is
``utils/jpeg.py::encode_jpeg_plain``, and the bytes are equal.

A frame on the card takes four kernels of K11's own and two of K3's
(:func:`~easygaussiansplatting_tpu_torch.ops.kernels.scan.multi_cumsum`):
(a) the coefficients, an MCU a CTA; (b) each block's Huffman bit length;
K3 over the lengths (bit offsets); (c) the packing into a zeroed word
buffer, then, after a grid barrier, the 0xFF bytes of each 1,024-byte
chunk; K3 over those counts; (d) the byte-stuffed scan and its length. The
host reads that length (the one wait of a frame) and copies that many
bytes; the headers are built once per (width, height, quality).
:func:`kernel_plan` asks the kernel library for a frame's plan.
"""

import ctypes
import functools

import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.ops.kernels.scan import multi_cumsum
from easygaussiansplatting_tpu_torch.utils import trace
from easygaussiansplatting_tpu_torch.utils.jpeg import (
    EOI,
    check_frame,
    code_tables,
    encode_jpeg_plain,
    headers,
    quant_tables,
)

PLAN_KEYS = ("mcus", "blocks", "chunks", "words", "out_bytes", "kernels", "memsets")
SCANS = 2  # K3 launches a frame
KERNELS = ("jpeg_blocks_kernel", "jpeg_lengths_kernel", "jpeg_pack_kernel", "jpeg_stuff_kernel")


def kernel_plan(width, height):
    """csrc/jpeg_encode.cu's plan for a frame: {"mcus", "blocks", "chunks"
    (of 1,024 packed bytes), "words" (of the packed scan), "out_bytes" (of
    the stuffed buffer), "kernels" (K11's own launches, 4), "memsets" (1)};
    the frame also takes SCANS launches of K3. Asks the kernel library, so
    it needs the CUDA toolkit."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _build.check(_build.library().egs_jpeg_plan(int(width), int(height), out), "egs_jpeg_plan")
    return dict(zip(PLAN_KEYS, out))


def kernel_info(which):
    """Kernel ``which`` (an index into KERNELS) as compiled: {"registers",
    "shared_bytes", "local_bytes" (spills), "blocks_per_sm", "threads"}."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().egs_jpeg_info(int(which), out), "egs_jpeg_info")
    return dict(zip(("registers", "shared_bytes", "local_bytes", "blocks_per_sm", "threads"),
                    out))


@functools.lru_cache(maxsize=32)
def quant_table(device, quality):
    """int32 [2, 64] luminance and chrominance tables, natural order, on
    ``device`` (cached: a frame uploads nothing)."""
    return torch.as_tensor(quant_tables(quality), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=8)
def huffman_table(device):
    """int32 [2, 4, 256]: codes, then lengths, of DC0, AC0, DC1, AC1."""
    return torch.as_tensor(code_tables(), dtype=torch.int32, device=device)


def _check_cuda(name, t, dtype, shape, device):
    if (t.device.type != "cuda" or t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def blocks(rgb, qtab):
    """K11 (a) on a CUDA frame: int16 [n_mcu, 6, 64] zigzag coefficients
    (utils/jpeg.py::coefficients's layout). ``rgb``: contiguous uint8
    [H, W, 3]; ``qtab``: int32 [2, 64] on its device."""
    check_frame(rgb)
    h, w, _ = rgb.shape
    _check_cuda("rgb", rgb, torch.uint8, (h, w, 3), rgb.device)
    _check_cuda("qtab", qtab, torch.int32, (2, 64), rgb.device)
    plan = kernel_plan(w, h)
    coef = torch.empty((plan["mcus"], 6, 64), dtype=torch.int16, device=rgb.device)
    _build.check(_build.library().egs_jpeg_blocks(
        rgb.data_ptr(), w, h, qtab.data_ptr(), coef.data_ptr(), _build.stream_ptr(rgb)),
        "egs_jpeg_blocks")
    return coef


def scan(coef, width, height):
    """K11 (b), K3, (c), K3, (d) on the coefficients: (the stuffed scan's
    buffer, uint8 [out_bytes], and its length, int32 [1]), both on the
    device; nothing waits."""
    plan = kernel_plan(width, height)
    dev = coef.device
    _check_cuda("coef", coef, torch.int16, (plan["mcus"], 6, 64), dev)
    n_blocks, n_chunks = plan["blocks"], plan["chunks"]
    huff = huffman_table(dev)
    lib = _build.library()
    stream = _build.stream_ptr(coef)
    lens = torch.empty((1, n_blocks), dtype=torch.int32, device=dev)
    _build.check(lib.egs_jpeg_lengths(coef.data_ptr(), n_blocks, huff.data_ptr(),
                                      lens.data_ptr(), stream), "egs_jpeg_lengths")
    ends = multi_cumsum(lens)
    words = torch.empty(plan["words"], dtype=torch.int32, device=dev)  # cleared by the C entry
    ff = torch.empty((1, n_chunks), dtype=torch.int32, device=dev)
    _build.check(lib.egs_jpeg_pack(coef.data_ptr(), n_blocks, huff.data_ptr(), ends.data_ptr(),
                                   words.data_ptr(), n_chunks, ff.data_ptr(), stream),
                 "egs_jpeg_pack")
    ff_ends = multi_cumsum(ff)
    out = torch.empty(plan["out_bytes"], dtype=torch.uint8, device=dev)
    out_len = torch.empty(1, dtype=torch.int32, device=dev)
    _build.check(lib.egs_jpeg_stuff(words.data_ptr(), ends.data_ptr(), n_blocks,
                                    ff_ends.data_ptr(), n_chunks, out.data_ptr(),
                                    out_len.data_ptr(), stream), "egs_jpeg_stuff")
    return out, out_len


def launch(rgb, quality=90):
    """Every kernel of a CUDA frame's encode, without waiting: (stuffed
    scan buffer, its length) on the device."""
    h, w, _ = rgb.shape
    return scan(blocks(rgb, quant_table(rgb.device, quality)), w, h)


def encode_jpeg(rgb, quality=90):
    """[H, W, 3] uint8 tensor -> the bytes of PIL's ``Image.save(format=
    "JPEG", quality=quality)`` (4:2:0, JFIF 1.01). A CPU tensor takes the
    plain version; a CUDA tensor launches K11 and waits once, for the
    scan's length."""
    check_frame(rgb)
    if rgb.device.type == "cpu":
        with trace.span("encode.launch"):
            return encode_jpeg_plain(rgb, quality)
    if rgb.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb.device}")
    with trace.span("encode.launch"):
        rgb = rgb.contiguous()
        out, out_len = launch(rgb, quality)
    encode_jpeg.launches += 1
    h, w, _ = rgb.shape
    with trace.span("encode.wait"):  # the host blocks on the device here
        stuffed = out[:int(out_len.item())].cpu().numpy().tobytes()
    return headers(w, h, quality) + stuffed + EOI


encode_jpeg.launches = 0
