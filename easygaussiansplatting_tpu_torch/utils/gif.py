"""An animated GIF89a writer on numpy and the standard library alone.

It takes the place of PIL's ``save_all`` GIF writer, which the JAX
package's ``viewer/headless.py::save_gif`` calls: the card's machine has no
PIL. Every frame is quantised to one fixed uniform palette of 6 x 7 x 6
levels (red, green, blue; 252 colours) by rounding each channel to its
nearest level, so a pixel lies within half a level step (25.5 of 255) of
its float value. PIL builds an adaptive palette per frame instead; this
writer does not match it.
"""

import struct

import numpy as np

LEVELS = (6, 7, 6)  # palette levels of red, green and blue
MAX_CODE = 4095  # GIF's LZW codes are at most 12 bits wide


def palette():
    """The [256, 3] uint8 palette: index (r * 7 + g) * 6 + b holds the
    levels (r, g, b); entries 252-255 are black."""
    r, g, b = np.meshgrid(*(np.arange(n) for n in LEVELS), indexing="ij")
    rgb = np.stack([r, g, b], axis=-1).reshape(-1, 3).astype(np.float64)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(rgb)] = np.round(rgb * 255.0 / (np.array(LEVELS) - 1))
    return pal


def quantize(frame):
    """A [3,H,W] float frame in [0, 1] (clipped) -> [H,W] uint8 palette
    indices, each channel rounded to its nearest level."""
    f = np.clip(np.asarray(frame, np.float64), 0.0, 1.0)
    idx = [np.rint(f[c] * (LEVELS[c] - 1)).astype(np.int32) for c in range(3)]
    return ((idx[0] * LEVELS[1] + idx[1]) * LEVELS[2] + idx[2]).astype(np.uint8)


def lzw_encode(indices, min_code_size=8):
    """GIF's variable-width LZW of a flat sequence of 8-bit indices: a clear
    code first, a clear code whenever the 12-bit table fills, an end code
    last; codes packed least significant bit first."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def fresh():
        return {bytes([i]): i for i in range(clear)}, end + 1, min_code_size + 1

    table, next_code, width = fresh()
    emit(clear, width)
    data = bytes(indices)
    prefix = b""
    for i in range(len(data)):
        cur = prefix + data[i:i + 1]
        if cur in table:
            prefix = cur
            continue
        emit(table[prefix], width)
        if next_code <= MAX_CODE:
            table[cur] = next_code
            if next_code == 1 << width and width < 12:
                width += 1
            next_code += 1
        else:  # table full: start over
            emit(clear, width)
            table, next_code, width = fresh()
        prefix = data[i:i + 1]
    if prefix:
        emit(table[prefix], width)
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data):
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames, fps=20):
    """[3,H,W] float frames -> the bytes of a looping animated GIF89a: the
    fixed palette as the global colour table, a NETSCAPE2.0 block with loop
    count 0 (forever), and each frame's delay int(1000 / fps) ms (stored in
    hundredths of a second, as PIL stores its ``duration``)."""
    frames = list(frames)
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    _, h, w = np.shape(frames[0])
    if w > 0xFFFF or h > 0xFFFF:
        raise ValueError(f"a GIF frame is at most 65535 pixels a side, got {w}x{h}")
    delay_cs = int(1000 / fps) // 10
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        if np.shape(f) != (3, h, w):
            raise ValueError(f"frame of shape {np.shape(f)}, expected {(3, h, w)}")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(b"\x08" + _sub_blocks(lzw_encode(quantize(f).reshape(-1).tobytes())))
    out.append(b"\x3b")
    return b"".join(out)


def save_gif(path, frames, fps=20):
    """Write [3,H,W] float frames as a looping animated GIF (:func:`encode_gif`)."""
    with open(path, "wb") as f:
        f.write(encode_gif(frames, fps))
