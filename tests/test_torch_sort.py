"""PyTorch port: K7's sort (the wrapper on CPU tensors, i.e. its plain
version) against the JAX Pallas bitonic sort run through the interpreter,
with block=512 and group=512 so that the cross-block kernel runs. Keys are
compared exactly; the JAX network is not stable, so with duplicate keys the
(key, payload) pairs are compared as multisets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.ops.pallas.sort import sort_blocks as jax_sort_blocks
from easygaussiansplatting_tpu.ops.pallas.sort import sort_pairs as jax_sort_pairs
from easygaussiansplatting_tpu_torch.ops.kernels import sort

torch.set_num_threads(2)

INT32_MAX = 2**31 - 1


def _words(a):
    """An array as int32 words (float payloads compare by their bits)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int32)


def _as_pairs(cols):
    """The rows of (key words..., payloads...) sorted lexicographically."""
    cols = [_words(c) for c in cols]
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols])


def _jax(keys, vals, n_keys=1):
    # every call at one length passes three arrays, so the interpreted
    # network is traced once per (length, n_keys)
    out = jax_sort_pairs(jnp.asarray(keys), *(jnp.asarray(v) for v in vals), n_keys=n_keys,
                         block=512, group=512, interpret=True)
    return [np.asarray(o) for o in out]


def _port(keys, vals, n_keys=1):
    before = sort.sort_pairs.launches
    out = sort.sort_pairs(torch.from_numpy(keys), *(torch.from_numpy(v) for v in vals),
                          n_keys=n_keys)
    assert sort.sort_pairs.launches == before  # CPU tensors launch nothing
    return [o.numpy() for o in out]


def _check(keys, vals, n_keys=1):
    """Keys exactly; pairs as multisets. Where real keys equal the pad key
    INT32_MAX, the JAX network may return pads (zero payloads) in place of
    some of them (its docstring hazard; callers never read those entries),
    so against JAX the pairs are compared below the pad key, and the port's
    pairs against the input's in full."""
    got, want = _port(keys, vals, n_keys), _jax(keys, vals, n_keys)
    assert len(got) == len(want) == 1 + len(vals)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == keys.shape
    for j in range(n_keys):
        np.testing.assert_array_equal(got[j], want[j])
    below = got[0] < INT32_MAX
    np.testing.assert_array_equal(_as_pairs([g[below] for g in got]),
                                  _as_pairs([w[below] for w in want]))
    np.testing.assert_array_equal(_as_pairs(got), _as_pairs([keys, *vals]))
    return got, want


@pytest.mark.parametrize("m", [1000, 4096])
def test_unique_keys_match_exactly(m):
    rng = np.random.default_rng(m)
    keys = rng.permutation(2**28)[:m].astype(np.int32)
    vals = [np.arange(m, dtype=np.int32), rng.normal(size=m).astype(np.float32)]
    got, want = _check(keys, vals)
    for g, w in zip(got, want):  # unique keys fix the order
        np.testing.assert_array_equal(_words(g), _words(w))


@pytest.mark.parametrize("m", [1000, 4096])
def test_duplicate_keys_match_as_multisets(m):
    """Heavy duplication and a tail keyed INT32_MAX, the pad key (the
    gradient reduce's dead patches)."""
    rng = np.random.default_rng(m + 1)
    keys = rng.integers(0, 17, size=m).astype(np.int32)
    keys[rng.random(m) < 0.2] = INT32_MAX
    vals = [np.arange(m, dtype=np.int32), rng.normal(size=m).astype(np.float32)]
    got, _ = _check(keys, vals)
    # the port's order is the stable one
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got[1], vals[0][order])


@pytest.mark.parametrize("m", [1000, 4096])
def test_two_key_words(m):
    """n_keys=2: binning's (tile, slot) lexicographic key."""
    rng = np.random.default_rng(m + 2)
    hi = rng.integers(0, 5, size=m).astype(np.int32)
    lo = rng.permutation(m).astype(np.int32)
    pay = rng.integers(-10**6, 10**6, size=m).astype(np.int32)
    got, want = _check(hi, [lo, pay], n_keys=2)
    order = np.lexsort((lo, hi))
    for g, w, a in zip(got, want, (hi, lo, pay)):
        np.testing.assert_array_equal(g, a[order])
        np.testing.assert_array_equal(w, a[order])


@pytest.mark.parametrize("m", [1000, 4096])
@pytest.mark.parametrize("layout", ["sorted", "reversed"])
def test_sorted_and_reversed_inputs(m, layout):
    keys = np.arange(m, dtype=np.int32) * 3
    if layout == "reversed":
        keys = keys[::-1].copy()
    f = np.random.default_rng(m).normal(size=m).astype(np.float32)
    got, want = _check(keys, [np.arange(m, dtype=np.int32), f])
    np.testing.assert_array_equal(got[0], np.sort(keys))
    np.testing.assert_array_equal(_words(got[2]), _words(want[2]))


def test_sort_blocks_matches_jax():
    rng = np.random.default_rng(5)
    m, block = 2048, 512
    keys = rng.integers(0, 40, size=m).astype(np.int32)
    vals = [np.arange(m, dtype=np.int32), rng.normal(size=m).astype(np.float32)]
    got = [o.numpy() for o in sort.sort_blocks(
        torch.from_numpy(keys), *(torch.from_numpy(v) for v in vals), block=block)]
    want = [np.asarray(o) for o in jax_sort_blocks(
        jnp.asarray(keys), *(jnp.asarray(v) for v in vals), block=block, interpret=True)]
    for b in range(0, m, block):
        s = slice(b, b + block)
        np.testing.assert_array_equal(got[0][s], want[0][s])
        np.testing.assert_array_equal(got[0][s], np.sort(keys[s]))
        np.testing.assert_array_equal(_as_pairs([g[s] for g in got]),
                                      _as_pairs([w[s] for w in want]))


def test_sort_blocks_two_key_words_is_blockwise_lexicographic():
    rng = np.random.default_rng(6)
    m, block = 1024, 256
    hi = rng.integers(0, 3, size=m).astype(np.int32)
    lo = rng.integers(0, 50, size=m).astype(np.int32)
    got = [o.numpy() for o in sort.sort_blocks(torch.from_numpy(hi), torch.from_numpy(lo),
                                                block=block, n_keys=2)]
    for b in range(0, m, block):
        order = np.lexsort((lo[b:b + block], hi[b:b + block]))
        np.testing.assert_array_equal(got[0][b:b + block], hi[b:b + block][order])
        np.testing.assert_array_equal(got[1][b:b + block], lo[b:b + block][order])


def test_wrappers_reject_bad_inputs():
    k = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_keys"):
        sort.sort_pairs(k, k, n_keys=3)
    with pytest.raises(ValueError, match="key word"):
        sort.sort_pairs(k, n_keys=2)
    with pytest.raises(ValueError, match="int32"):
        sort.sort_pairs(k.long())
    with pytest.raises(ValueError, match="value 0"):
        sort.sort_pairs(k, torch.zeros(255, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        sort.sort_pairs(torch.zeros(512, dtype=torch.int32)[::2])
    for block in (96, 64, 512):  # not a power of two; below 128; does not divide 256
        with pytest.raises(ValueError, match="block"):
            sort.sort_blocks(k, block=block)
