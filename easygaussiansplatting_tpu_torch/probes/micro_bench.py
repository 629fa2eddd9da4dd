"""K9: per-block overhead of the raster layout, and binning's sub-steps.

Port of scripts/micro_bench.py, run as

    python -m easygaussiansplatting_tpu_torch.probes.micro_bench [--device cpu]

At the script's sizes (q = 6,266 chunks of ``packed`` [16, q*256], 2,170
tiles, ``tiles`` non-decreasing, both from ``default_rng(0)``) it prints one
``label ms`` line for each of:

  A. streaming every [16, 256] chunk with no output but a block of zeros;
  B. adding rows 0-2 of each chunk into its tile's [3, 256] output block;
  V. summing rows 0-2 of each chunk over its pixels into [n_tiles, 3];
  D1-D5. binning's sub-steps as plain torch ops (argsort, searchsorted,
     stable pair sort, scatter, gather) at N = 65,536 and 2^20.

A, B and V are the three kernels of ``csrc/micro_bench.cu``; each public
function keeps the JAX signature and layouts and has its plain PyTorch
version beside it. CPU tensors take the plain version; CUDA tensors launch
the kernel. A streams every chunk into shared memory by ``cp.async``; B
runs a block per tile and a thread per pixel; V a warp per tile, which
finds its chunks by a 128-ary search and sums them by float4 loads in a
fixed tree. A and V read ``packed`` 16 bytes at a time, so on the card it
must be 16-byte aligned. The plain versions check that ``tiles`` is
non-decreasing and in range, and raise; the CUDA path checks layouts only
(a value check would read the device), and its searches stay in bounds
whatever the values, but its sums for such ``tiles`` are unspecified.
:func:`kernel_info` gives what the compiled V kernel takes on the card.

Where the TPU semantics leave B open, the port defines it: the Pallas kernel
initialises only the output block of ``tiles[0]``, so every other tile
starts from whatever its buffer held. Here ``img[t]`` is the sum of tile t's
chunks in chunk order, zero for a tile that no chunk visits, and ``tau`` is 1
everywhere.
"""

import argparse
import ctypes
import time

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.ops.kernels import _build
from easygaussiansplatting_tpu_torch.utils.device import resolve_device, synchronize

K = 256     # columns of a chunk: one 16x16 tile's pixels
ROWS = 16   # rows of ``packed``
Q_TOTAL, N_TILES = 6266, 2170
N_GAUSSIANS, MAX_PATCHES = 65536, 2**20
ITERS = 20


def _check_layout(q_total, packed, tiles):
    if packed.dtype != torch.float32 or tuple(packed.shape) != (ROWS, q_total * K):
        raise ValueError(f"packed must be float32 [{ROWS}, {q_total * K}], got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if tiles.dtype != torch.int32 or tuple(tiles.shape) != (q_total,):
        raise ValueError(f"tiles must be int32 [{q_total}], got {tiles.dtype} {tuple(tiles.shape)}")
    if not (packed.is_contiguous() and tiles.is_contiguous()) or tiles.device != packed.device:
        raise ValueError("packed and tiles must be contiguous and on one device")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")


def _check_aligned(packed):
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned: the kernel reads it 16 bytes at a time")


def _check_tiles(tiles, n_tiles=None):
    """The precondition of the plain versions: ``tiles`` non-decreasing and
    in [0, n_tiles) (or non-negative when n_tiles is None)."""
    if tiles.numel() == 0:
        return
    if bool((tiles[1:] < tiles[:-1]).any()):
        raise ValueError("tiles must be non-decreasing")
    top = None if n_tiles is None else n_tiles - 1
    if int(tiles[0]) < 0 or (top is not None and int(tiles[-1]) > top):
        raise ValueError(f"tiles must lie in [0, {n_tiles})")


def variant_a_plain(q_total, packed, tiles):
    """Plain PyTorch version of K9a: the [8, 128] block of zeros."""
    _check_tiles(tiles)
    return torch.zeros((8, 128), dtype=torch.float32, device=packed.device)


def variant_a(q_total, packed, tiles):
    """K9a: stream every [16, 256] chunk of ``packed`` [16, q_total*256]
    through shared memory and return an [8, 128] block of zeros."""
    _check_layout(q_total, packed, tiles)
    if packed.device.type == "cpu":
        return variant_a_plain(q_total, packed, tiles)
    _check_aligned(packed)
    if q_total == 0:  # no chunk to stream, so no block to write the zeros
        return torch.zeros((8, 128), dtype=torch.float32, device=packed.device)
    out = torch.empty((8, 128), dtype=torch.float32, device=packed.device)
    _build.check(_build.library().egs_stream_chunks(
        packed.data_ptr(), q_total * K, q_total, out.data_ptr(), out.numel(),
        _build.stream_ptr(packed)), "egs_stream_chunks")
    variant_a.launches += 1
    return out


variant_a.launches = 0


def _chunk_rows_by_tile(q_total, n_tiles, packed, tiles):
    """Yields, for k = 0, 1, ..., rows 0-2 of each tile's k-th chunk as
    [n_tiles, 3, 256], zero where the tile has fewer than k + 1 chunks."""
    _check_tiles(tiles, n_tiles)
    bounds = torch.searchsorted(
        tiles, torch.arange(n_tiles + 1, dtype=torch.int32, device=tiles.device))
    start, count = bounds[:-1], bounds[1:] - bounds[:-1]
    chunks = packed[:3].reshape(3, q_total, K)
    for k in range(int(count.max()) if n_tiles and q_total else 0):
        rows = chunks[:, torch.clamp(start + k, max=q_total - 1)].transpose(0, 1)
        yield torch.where((count > k)[:, None, None], rows, 0.0)


def variant_b_plain(q_total, n_tiles, packed, tiles):
    """Plain PyTorch version of K9b: float32 sums in chunk order, as the
    kernel adds them."""
    img = torch.zeros((n_tiles, 3, K), dtype=torch.float32, device=packed.device)
    for rows in _chunk_rows_by_tile(q_total, n_tiles, packed, tiles):
        img = img + rows
    return img, torch.ones((n_tiles, K, 1), dtype=torch.float32, device=packed.device)


def variant_b(q_total, n_tiles, packed, tiles):
    """K9b: ``img`` [n_tiles, 3, 256], the sum of rows 0-2 of every chunk c
    into tile ``tiles[c]`` (zero for a tile no chunk visits), and ``tau``
    [n_tiles, 256, 1] of ones. ``tiles`` must be non-decreasing and in
    [0, n_tiles): the plain version raises otherwise, while the kernel, which
    does not read the values back to the host, gives an unspecified ``img``
    (a chunk whose tile breaks the order or the range may be left out)."""
    _check_layout(q_total, packed, tiles)
    if packed.device.type == "cpu":
        return variant_b_plain(q_total, n_tiles, packed, tiles)
    img = torch.empty((n_tiles, 3, K), dtype=torch.float32, device=packed.device)
    tau = torch.empty((n_tiles, K, 1), dtype=torch.float32, device=packed.device)
    if n_tiles == 0:
        return img, tau
    _build.check(_build.library().egs_tile_sums(
        packed.data_ptr(), q_total * K, tiles.data_ptr(), q_total, n_tiles, img.data_ptr(),
        tau.data_ptr(), None, 0, _build.stream_ptr(packed)), "egs_tile_sums")
    variant_b.launches += 1
    return img, tau


variant_b.launches = 0


def variant_vmem_resident_plain(q_total, n_tiles, packed, tiles):
    """Plain PyTorch version of K9v, in the Pallas kernel's order: each
    chunk's rows summed over its pixels, the sums added in chunk order."""
    out = torch.zeros((n_tiles, 3), dtype=torch.float32, device=packed.device)
    for rows in _chunk_rows_by_tile(q_total, n_tiles, packed, tiles):
        out = out + rows.sum(dim=2)
    return out


def variant_vmem_resident(q_total, n_tiles, packed, tiles):
    """K9v: ``out`` [n_tiles, 3], rows 0-2 of every chunk summed over its 256
    pixels into tile ``tiles[c]``. ``tiles`` must be non-decreasing and in
    [0, n_tiles); on the card ``out`` is unspecified otherwise, as for
    :func:`variant_b`."""
    _check_layout(q_total, packed, tiles)
    if packed.device.type == "cpu":
        return variant_vmem_resident_plain(q_total, n_tiles, packed, tiles)
    _check_aligned(packed)
    out = torch.empty((n_tiles, 3), dtype=torch.float32, device=packed.device)
    if n_tiles == 0:
        return out
    _build.check(_build.library().egs_tile_sums(
        packed.data_ptr(), q_total * K, tiles.data_ptr(), q_total, n_tiles, None, None,
        out.data_ptr(), 1, _build.stream_ptr(packed)), "egs_tile_sums")
    variant_vmem_resident.launches += 1
    return out


variant_vmem_resident.launches = 0

INFO_KEYS = ("registers", "shared_bytes", "local_bytes", "blocks_per_sm", "threads",
             "tiles_per_block")


def kernel_info():
    """What the compiled K9v kernel takes on the card: {"registers": per
    thread, "shared_bytes": per block, "local_bytes": per thread (spills),
    "blocks_per_sm": resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "threads": per block,
    "tiles_per_block": one a warp}. Builds the kernels first if needed;
    needs the card."""
    fn = _build.library().egs_tile_totals_info
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * len(INFO_KEYS))()
    _build.check(fn(ctypes.addressof(out)), "egs_tile_totals_info")
    return dict(zip(INFO_KEYS, out))


def make_inputs(device, q_total=Q_TOTAL, n_tiles=N_TILES):
    """``packed`` and ``tiles`` as the script makes them, and the generator
    left where the script's D steps continue from it."""
    rng = np.random.default_rng(0)
    packed = rng.normal(size=(ROWS, q_total * K)).astype(np.float32)
    # realistic: ~2-3 consecutive chunks per tile, non-decreasing
    tiles = np.minimum(np.sort(rng.integers(0, n_tiles, q_total)), n_tiles - 1).astype(np.int32)
    return torch.from_numpy(packed).to(device), torch.from_numpy(tiles).to(device), rng


def timeit(label, fn, device, iters=ITERS):
    """Mean ms per call of ``fn`` over ``iters`` calls after one warm call:
    CUDA events around the calls on the card, the host clock on the CPU.
    Prints ``label ms`` as the script does."""
    fn()
    synchronize(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / iters
    print(f"{label:42s} {ms:9.3f} ms", flush=True)
    return ms


def run(device="cuda", q_total=Q_TOTAL, n_tiles=N_TILES, n=N_GAUSSIANS,
        max_patches=MAX_PATCHES):
    """Time A, B, V and D1-D5 on ``device``; returns {label: ms}."""
    dev = resolve_device(device)
    packed, tiles, rng = make_inputs(dev, q_total, n_tiles)
    out = {}

    def t(label, fn):
        out[label] = timeit(label, fn, dev)

    t("A: stream only (no outputs)", lambda: variant_a(q_total, packed, tiles))
    t("B: + tile-indexed out blocks", lambda: variant_b(q_total, n_tiles, packed, tiles))
    t("V: resident per-tile sums", lambda: variant_vmem_resident(q_total, n_tiles, packed, tiles))

    # ---- binning sub-steps, as plain torch ops ----
    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    depths = dev_t(rng.uniform(1, 10, n).astype(np.float32))
    t("D1: argsort N", lambda: torch.argsort(depths, stable=True))
    cum = dev_t(np.sort(rng.integers(0, max_patches, n)).astype(np.int32))
    m = torch.arange(max_patches, dtype=torch.int32, device=dev)
    t(f"D2: searchsorted expand ({max_patches} over {n})",
      lambda: torch.searchsorted(cum, m, right=True))
    tile_id = dev_t(rng.integers(0, n_tiles, max_patches).astype(np.int32))
    gsid = dev_t(rng.integers(0, n, max_patches).astype(np.int32))

    def sort_gather(key, stable):
        skey, order = torch.sort(key, stable=stable)
        return skey, gsid[order]

    t(f"D3a: stable pair sort ({max_patches})", lambda: sort_gather(tile_id, True))
    t(f"D3b: sort + gather i32 ({max_patches})", lambda: sort_gather(tile_id, False))
    key64 = (tile_id.long() << 20) | m.long()
    t(f"D3c: sort + gather i64 ({max_patches})", lambda: sort_gather(key64, False))
    newpos = dev_t(rng.permutation(max_patches + 1000)[:max_patches].astype(np.int64))
    t(f"D4: scatter {max_patches}",
      lambda: torch.full((max_patches + 1000,), -1, dtype=torch.int32, device=dev)
      .scatter_(0, newpos, gsid))
    rows9 = dev_t(rng.normal(size=(n, 9)).astype(np.float32))
    t(f"D5: gather {max_patches} x 9 rows", lambda: rows9.index_select(0, gsid))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
