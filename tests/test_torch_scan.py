"""PyTorch port: K3 multi-row cumsum and K6 segmented cumsum (plain versions
on the CPU) against the JAX Pallas scan kernels run through the interpreter,
the gradient sort-reduce against the JAX one, and the wrappers' input
checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from easygaussiansplatting_tpu.ops.pallas import scan as jax_scan
from easygaussiansplatting_tpu.ops.pallas.rasterize import _sort_reduce_grads
from easygaussiansplatting_tpu_torch.data.fixtures import (
    SCAN_CASES,
    SCAN_TILE,
    SEG_CASES,
    SEG_TILE,
    scan_case,
    segment_case,
)
from easygaussiansplatting_tpu_torch.ops.kernels import scan
from easygaussiansplatting_tpu_torch.ops.kernels.rasterize import sort_reduce_grads

torch.set_num_threads(2)


def _interpreted_scan_kernel(rows, lanes=128):
    """The Pallas kernel itself, as tests/test_scan.py runs it."""
    r, m = rows.shape
    return pl.pallas_call(
        jax_scan._scan_kernel,
        grid=(m // lanes,),
        in_specs=[pl.BlockSpec((r, lanes), lambda c: (0, c), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((r, lanes), lambda c: (0, c), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(rows.shape, rows.dtype),
        scratch_shapes=[pltpu.VMEM((r, 1), rows.dtype)],
        interpret=True,
    )(rows)


@pytest.mark.parametrize("r,m", [(1, 640), (2, 1152), (8, 384)])
def test_int32_matches_interpreted_kernel(rng, r, m):
    # lengths that are multiples of the interpreter's 128-lane block but not
    # of the TPU kernel's 16,384-lane block
    x = rng.integers(-50, 50, size=(r, m)).astype(np.int32)
    want = np.asarray(_interpreted_scan_kernel(jnp.asarray(x)))
    got = scan.multi_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_float32_matches_interpreted_kernel(rng):
    x = rng.normal(size=(3, 1024)).astype(np.float32)
    want = np.asarray(_interpreted_scan_kernel(jnp.asarray(x)))
    got = scan.multi_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.float32
    # the two sum in different orders (blocked doubling vs sequential):
    # a few ulps of the running sum's magnitude (<= ~40 here)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * 40, rtol=0)


@pytest.mark.parametrize("m", [1, 1000, 16385, 20000])
def test_any_length_matches_jax_multi_cumsum(rng, m):
    x = rng.integers(0, 9, size=(2, m)).astype(np.int32)
    want = np.asarray(jax_scan.multi_cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(scan.multi_cumsum(torch.from_numpy(x)).numpy(), want)


def test_int32_wraps_like_jax():
    x = np.full((1, 4), 2**30, np.int32)
    want = np.asarray(jax_scan.multi_cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(scan.multi_cumsum(torch.from_numpy(x)).numpy(), want)


def test_batched_cumsum_list(rng):
    arrays = [rng.integers(0, 9, size=1024).astype(np.int32) for _ in range(4)]
    want = jax_scan.batched_cumsum([jnp.asarray(a) for a in arrays])
    got = scan.batched_cumsum([torch.from_numpy(a) for a in arrays])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _interpreted_padded(x, lanes=1024):
    """The Pallas kernel on rows zero-padded to a multiple of its block
    (the padding's cumsum leaves the prefix as it is), cut back to m."""
    r, m = x.shape
    padded = np.zeros((r, -(-m // lanes) * lanes), x.dtype)
    padded[:, :m] = x
    return np.asarray(_interpreted_scan_kernel(jnp.asarray(padded), lanes=lanes))[:, :m]


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("kind", SCAN_CASES)
def test_int32_matches_jax_at_tile_edges(kind, rows):
    """The edges of the CUDA kernel's tiles of SCAN_TILE positions
    (data/fixtures.py::scan_case: m at the tile and one off it, several
    tiles, sums that wrap past 2^31 across tile boundaries, m % 4 != 0 with
    row 1 unaligned) against the interpreted Pallas kernel and JAX
    ``multi_cumsum`` in interpret mode: equal, wrap included."""
    x = scan_case(kind, rows)
    assert x.shape[1] in range(SCAN_TILE - 1, 4 * SCAN_TILE)
    got = scan.multi_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _interpreted_padded(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_scan.multi_cumsum(jnp.asarray(x), interpret=True)))


@pytest.mark.parametrize("kind", [k for k in SCAN_CASES if k != "wrap"])
def test_float32_matches_jax_at_tile_edges(kind):
    """float32 rows at K3's tile edges: within 1e-5 of the running sum of
    |x| of the interpreted Pallas kernel and of JAX ``multi_cumsum`` in
    interpret mode (sums in other orders)."""
    x = scan_case(kind, rows=3, dtype=np.float32)
    got = scan.multi_cumsum(torch.from_numpy(x)).numpy()
    mag = np.cumsum(np.abs(x.astype(np.float64)), axis=1)
    for want in (_interpreted_padded(x),
                 np.asarray(jax_scan.multi_cumsum(jnp.asarray(x), interpret=True))):
        assert np.all(np.abs(got - want) <= 1e-5 * mag)


@pytest.mark.parametrize("bad", ["int64", "rows", "dim", "noncontig"])
def test_wrapper_rejects(bad):
    x = torch.zeros((2, 16), dtype=torch.int32)
    if bad == "int64":
        x, err = x.long(), TypeError
    elif bad == "rows":
        x, err = torch.zeros((9, 16), dtype=torch.int32), ValueError
    elif bad == "dim":
        x, err = torch.zeros(16, dtype=torch.int32), ValueError
    else:
        x, err = torch.zeros((16, 2), dtype=torch.int32).t(), ValueError
    with pytest.raises(err):
        scan.multi_cumsum(x)



def _interpreted_seg_scan_kernel(vals, flags, lanes=128):
    """``_seg_scan_kernel`` itself, as tests/test_scan.py runs it."""
    r, m = vals.shape
    return pl.pallas_call(
        jax_scan._seg_scan_kernel,
        grid=(m // lanes,),
        in_specs=[
            pl.BlockSpec((r, lanes), lambda c: (0, c), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, lanes), lambda c: (0, c), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((r, lanes), lambda c: (0, c), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((r, m), jnp.float32),
        scratch_shapes=[pltpu.VMEM((r, 1), jnp.float32)],
        interpret=True,
    )(vals, flags[None, :])


@pytest.mark.parametrize("starts", [[0, 300], [0], [0, 127, 128, 400], "random"])
def test_segmented_matches_interpreted_kernel(starts):
    """Segments that span the interpreter's 128-lane blocks, starts at and
    next to a block edge, and random flags. atol 1e-5: float32 sums in
    another order (the plain version sums in float64)."""
    rng = np.random.default_rng(3)
    r, m = 9, 512
    vals = rng.normal(size=(r, m)).astype(np.float32)
    if starts == "random":
        flags = (rng.random(m) < 0.1).astype(np.int32)
        flags[0] = 1
    else:
        flags = np.zeros(m, np.int32)
        flags[starts] = 1
    want = np.asarray(_interpreted_seg_scan_kernel(jnp.asarray(vals), jnp.asarray(flags)))
    got = scan.segmented_cumsum(torch.from_numpy(vals), torch.from_numpy(flags))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_segmented_no_cross_segment_cancellation():
    """A huge segment before a tiny one: the tiny one's sums stay exact."""
    vals = np.array([[1e7, 3e7, -2e7, 1.0, 2.0, 3.0]], np.float32)
    flags = np.array([1, 0, 0, 1, 0, 0], np.int32)
    got = scan.segmented_cumsum(torch.from_numpy(vals), torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy()[0, 3:], [1.0, 3.0, 6.0])


@pytest.mark.parametrize("kind", SEG_CASES)
def test_segmented_matches_jax_at_tile_edges(kind):
    """The edges of the CUDA kernel's tiles of SEG_TILE positions (m at the
    tile and one off it, a segment over three tiles, a tile with no start,
    starts at tiles' first and last positions, one segment, a start at every
    position) against JAX ``segmented_cumsum`` as it runs off the TPU (its
    associative-scan reference). float32 sums in another order than the
    float64 plain version: within 1e-5 of the running sum of |x|."""
    vals, flags = segment_case(kind)
    assert vals.shape[1] in range(SEG_TILE - 1, 6 * SEG_TILE)
    want = np.asarray(jax_scan.segmented_cumsum(jnp.asarray(vals), jnp.asarray(flags)))
    got = scan.segmented_cumsum(torch.from_numpy(vals), torch.from_numpy(flags)).numpy()
    mag = scan.segmented_cumsum_plain(torch.from_numpy(np.abs(vals)),
                                      torch.from_numpy(flags)).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-6)
    if kind == "every_position":
        np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("bad", ["int32", "dim", "flags_len", "flags_dtype"])
def test_segmented_wrapper_rejects(bad):
    vals = torch.zeros((9, 16))
    flags = torch.zeros(16, dtype=torch.int32)
    if bad == "int32":
        vals = vals.int()
    elif bad == "dim":
        vals = torch.zeros(16)
    elif bad == "flags_len":
        flags = torch.zeros(15, dtype=torch.int32)
    else:
        flags = flags.bool()
    with pytest.raises(ValueError):
        scan.segmented_cumsum(vals, flags)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sort_reduce_matches_jax(rng, use_kernels):
    """The port's sort + segmented sum + segment-end gather against the JAX
    ``_sort_reduce_grads`` on the same per-patch rows, dead patches (gsid -1)
    included (tests/test_pallas.py drives the JAX one the same way)."""
    m, n = 3000, 300
    gsid = rng.integers(-1, n, size=m).astype(np.int32)
    live = gsid >= 0
    rows = np.where(live[None, :], rng.normal(size=(9, m)), 0.0).astype(np.float32)
    counts = np.bincount(gsid[live], minlength=n).astype(np.int32)
    want = np.asarray(_sort_reduce_grads(jnp.asarray(rows), jnp.asarray(np.maximum(gsid, 0)),
                                         jnp.asarray(live), jnp.asarray(counts), n))
    got = sort_reduce_grads(torch.from_numpy(rows), torch.from_numpy(gsid),
                            torch.from_numpy(counts), use_kernels)
    assert got.shape == (n, 9)
    np.testing.assert_allclose(got.numpy().T, want, atol=2e-5, rtol=0)
    assert np.all(got.numpy()[counts == 0] == 0.0)
