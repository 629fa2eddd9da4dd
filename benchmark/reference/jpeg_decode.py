"""What a served JPEG says: its quantised DCT coefficients, read back from
the entropy-coded scan of a baseline 4:2:0 JPEG with the standard Huffman
tables (the only kind :mod:`benchmark.reference.jpeg` writes; a body whose
headers differ from that encoder's is refused before the scan is read).

``coefficients(body, width, height, quality)`` returns int [n_mcu, 6, 64]
in zigzag order, MCUs in raster order and blocks Y00, Y01, Y10, Y11, Cb,
Cr: the layout of the encoder's ``coefficients``, so the two compare
element by element. A pure-Python walk over the tokens, fast enough for a
sample of frames.
"""

import numpy as np

from benchmark.reference import jpeg

_COMPONENT_OF_BLOCK = (0, 0, 0, 0, 1, 2)  # Y, Y, Y, Y, Cb, Cr
_TABLE_OF_COMPONENT = (0, 1, 1)  # luma tables for Y, chroma tables for Cb and Cr


class JpegError(ValueError):
    """A body that is not the baseline JPEG the encoder writes."""


def _lookup(bits, vals):
    """16-bit prefix -> (symbol, code length), as two lists of 65536."""
    codes, lens = jpeg.huffman_codes(bits, vals)
    sym, ln = [0] * 65536, [0] * 65536
    for s in vals:
        n = int(lens[s])
        c = int(codes[s]) << (16 - n)
        for p in range(c, c + (1 << (16 - n))):
            sym[p], ln[p] = s, n
    return sym, ln


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = [_lookup(bits, vals) for bits, vals in jpeg.HUFF_TABLES]
    return _TABLES  # DC0, AC0, DC1, AC1


def _scan_bits(scan):
    """The unstuffed scan as a list of the 16-bit windows at each bit
    position, padded with ones."""
    data = np.frombuffer(scan, np.uint8)
    ff = np.flatnonzero(data[:-1] == 0xFF)
    if len(ff) and np.any(data[ff + 1] != 0):
        raise JpegError("a marker inside the entropy-coded scan")
    data = np.delete(data, ff + 1)
    bits = np.unpackbits(np.concatenate([data, np.full(4, 0xFF, np.uint8)])).astype(np.uint32)
    n = len(bits) - 16
    win = np.zeros(n, np.uint32)
    for i in range(16):
        win = (win << 1) | bits[i:i + n]
    return win.tolist(), 8 * len(data)


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def coefficients(body, width, height, quality=90):
    """The quantised coefficients a body holds (see the module docstring).
    Raises :class:`JpegError` where the body is not that kind of JPEG."""
    head = jpeg.headers(width, height, quality)
    if body[:len(head)] != head:
        raise JpegError("headers differ from the baseline encoder's for this size")
    if body[-2:] != jpeg.EOI:
        raise JpegError("no end-of-image marker")
    win, nbits = _scan_bits(body[len(head):-2])
    tabs = _tables()
    mr, mc = jpeg.mcu_grid(width, height)
    out = np.zeros((mr * mc, jpeg.BLOCKS_PER_MCU, 64), np.int64)
    pred = [0, 0, 0]
    pos = 0
    for m in range(mr * mc):
        for b in range(jpeg.BLOCKS_PER_MCU):
            comp = _COMPONENT_OF_BLOCK[b]
            t = _TABLE_OF_COMPONENT[comp]
            dsym, dlen = tabs[2 * t]
            asym, alen = tabs[2 * t + 1]
            w = win[pos]
            s, n = dsym[w], dlen[w]
            if n == 0:
                raise JpegError("no DC code matches")
            pos += n
            diff = _extend(win[pos] >> (16 - s), s) if s else 0
            pos += s
            pred[comp] += diff
            blk = out[m, b]
            blk[0] = pred[comp]
            k = 1
            while k < 64:
                w = win[pos]
                rs, n = asym[w], alen[w]
                if n == 0:
                    raise JpegError("no AC code matches")
                pos += n
                r, s = rs >> 4, rs & 15
                if s == 0:
                    if r == 15:
                        k += 16
                        continue
                    break  # end of block
                k += r
                if k > 63:
                    raise JpegError("a run past the block's end")
                blk[k] = _extend(win[pos] >> (16 - s), s)
                pos += s
                k += 1
            if pos > nbits:
                raise JpegError("the scan ends inside a block")
    if nbits - pos >= 8:
        raise JpegError("bytes left over after the last block")
    return out
