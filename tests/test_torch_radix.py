"""PyTorch port: K8's counting sort (the wrapper on CPU tensors, i.e. its
plain version) against the JAX Pallas counting sort run through the
interpreter (chunk=512; the XLA-scatter concatenation, and once the DMA
concatenation kernel). A stable sort fixes its output, so keys and payloads
must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.ops.pallas.radix import counting_sort as jax_counting_sort
from easygaussiansplatting_tpu.ops.pallas.radix import (
    counting_sort_by_tile as jax_counting_sort_by_tile,
)
from easygaussiansplatting_tpu_torch.ops.kernels import radix

torch.set_num_threads(2)


def _port(key, vals, key_bound):
    before = radix.counting_sort.launches
    out = radix.counting_sort(torch.from_numpy(key.astype(np.int32)),
                              *(torch.from_numpy(v.astype(np.int32)) for v in vals),
                              key_bound=key_bound)
    assert radix.counting_sort.launches == before  # CPU tensors launch nothing
    return [o.numpy() for o in out]


def _check(key, vals, key_bound, dma=False):
    got = _port(key, vals, key_bound)
    want = jax_counting_sort(jnp.asarray(key, jnp.int32),
                             *(jnp.asarray(v, jnp.int32) for v in vals), key_bound=key_bound,
                             chunk=512, interpret=True, dma=dma)
    order = np.argsort(key, kind="stable")
    for g, w, a in zip(got, want, [key, *vals]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, a[order])


@pytest.mark.parametrize("dma", [False, True])
def test_random_tiles(dma):
    rng = np.random.default_rng(0)
    m, n_tiles = 2048, 300  # > 64 buckets: two passes
    tile = rng.integers(0, n_tiles + 1, m)
    _check(tile, [rng.integers(-1, 5000, m)], n_tiles + 1, dma)


def test_skew_into_one_tile():
    m = 1024
    _check(np.full(m, 7), [np.arange(m)], 101)


def test_empty_buckets_and_the_padding_bucket():
    rng = np.random.default_rng(2)
    m, n_tiles = 1536, 200
    tile = rng.choice([3, 64, 65, 130, n_tiles], m)  # n_tiles: the padding bucket
    _check(tile, [rng.integers(0, 10, m)], n_tiles + 1)


@pytest.mark.parametrize("key_bound", [5000, 65537])
def test_multi_pass_key_bound(key_bound):
    """3 passes at 65,537 (the gradient reduce: gaussian ids, dead patches in
    the top bucket)."""
    rng = np.random.default_rng(key_bound)
    m = 2048
    key = rng.integers(0, key_bound, m)
    key[rng.random(m) < 0.1] = key_bound - 1
    _check(key, [np.arange(m)], key_bound)


def test_odd_lengths():
    """m = 3 * 512 against JAX (whose chunk shrinks to 512); m = 1001, which
    the Pallas version cannot take, against numpy's stable sort."""
    rng = np.random.default_rng(5)
    _check(rng.integers(0, 301, 1536), [np.arange(1536)], 301)
    key = rng.integers(0, 301, 1001)
    got = _port(key, [np.arange(1001)], 301)
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(got[0], key[order])
    np.testing.assert_array_equal(got[1], order)


def test_stability_and_the_by_tile_entry():
    rng = np.random.default_rng(4)
    m, n_tiles = 2048, 90
    tile = rng.integers(0, n_tiles, m).astype(np.int32)
    ts, gs = radix.counting_sort_by_tile(torch.from_numpy(tile),
                                         torch.arange(m, dtype=torch.int32), n_tiles=n_tiles)
    jts, jgs = jax_counting_sort_by_tile(jnp.asarray(tile), jnp.arange(m, dtype=jnp.int32),
                                         n_tiles=n_tiles, chunk=512, interpret=True, dma=False)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))
    for t in np.unique(tile):
        assert np.all(np.diff(gs.numpy()[ts.numpy() == t]) > 0)  # input order within a tile


def test_float_payload_moves_as_bits():
    rng = np.random.default_rng(6)
    key = torch.from_numpy(rng.integers(0, 70, 500).astype(np.int32))
    f = torch.from_numpy(rng.normal(size=500).astype(np.float32))
    ks, fs = radix.counting_sort(key, f, key_bound=70)
    order = np.argsort(key.numpy(), kind="stable")
    np.testing.assert_array_equal(fs.numpy().view(np.int32), f.numpy()[order].view(np.int32))


def test_wrapper_rejects_bad_inputs():
    k = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="key"):
        radix.counting_sort(k.long(), key_bound=4)
    with pytest.raises(ValueError, match="key_bound"):
        radix.counting_sort(k, key_bound=0)
    with pytest.raises(ValueError, match="value 0"):
        radix.counting_sort(k, torch.zeros(15, dtype=torch.int32), key_bound=4)


@pytest.mark.parametrize("key_bound", [1, 2, 256, 257, 2**31 - 1])
def test_key_bounds(key_bound):
    """One 8-bit pass (1, 2, 256 buckets), two (257: a last pass of 2
    buckets) and four (2^31 - 1), against JAX's 6-bit passes."""
    rng = np.random.default_rng(key_bound % 1000)
    m = 2048
    key = rng.integers(0, key_bound, m)
    key[rng.random(m) < 0.2] = key_bound - 1
    _check(key, [np.arange(m)], key_bound)


@pytest.mark.parametrize("key_bound", [2, 300, 65537])
def test_every_key_in_one_bucket(key_bound):
    """One digit over every tile of every pass: the stable order is the
    input order."""
    m = 1536
    _check(np.full(m, key_bound // 2), [np.arange(m)], key_bound)


def test_length_limit():
    """Lengths of 2^30 and more are refused (the look-back words hold 30-bit
    counts); meta tensors, so nothing is allocated."""
    with pytest.raises(ValueError, match="below 2"):
        radix.counting_sort(torch.empty(2**30, dtype=torch.int32, device="meta"), key_bound=4)
    with pytest.raises(ValueError, match="device"):
        radix.counting_sort(torch.empty(2**30 - 1, dtype=torch.int32, device="meta"),
                            key_bound=4)
