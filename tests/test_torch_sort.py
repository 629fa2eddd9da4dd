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


@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("m", [1, 3, 777, 4097])
def test_odd_lengths_and_one_past_the_tile(m, n_keys):
    """Lengths the merge sort takes as they are (no power-of-two padding):
    m = 1, odd lengths, and one past the kernel's 4,096-entry tile (a merge
    with a one-entry right run), with one key word and with two."""
    rng = np.random.default_rng(m + 7)
    words = [rng.integers(-50, 50, size=m).astype(np.int32) for _ in range(2)]
    vals = words[1:n_keys] + [np.arange(m, dtype=np.int32),
                              rng.normal(size=m).astype(np.float32)]
    got, _ = _check(words[0], vals, n_keys)
    np.testing.assert_array_equal(got[n_keys], np.lexsort(words[:n_keys][::-1]))


@pytest.mark.parametrize("n_keys", [1, 2])
def test_signed_extremes(n_keys):
    """Key words at and next to INT32_MIN, 0 and INT32_MAX: the order is on
    signed words, lexicographic for two. A power-of-two length: the JAX
    network pads others with (INT32_MAX, 0), which may displace real
    (INT32_MAX, x) entries past the slice."""
    rng = np.random.default_rng(8 + n_keys)
    m = 1024
    pick = np.array([-2**31, -2**31 + 1, -1, 0, 1, INT32_MAX - 1, INT32_MAX], np.int32)
    words = [pick[rng.integers(0, 7, m)] for _ in range(2)]
    vals = words[1:n_keys] + [np.arange(m, dtype=np.int32)]
    got, _ = _check(words[0], vals, n_keys)
    order = np.lexsort(words[:n_keys][::-1])  # stable, by the last key given first
    np.testing.assert_array_equal(got[-1], order)


@pytest.mark.parametrize("n_keys", [1, 2])
def test_all_equal_keys(n_keys):
    """Every key word equal: the stable order is the input order."""
    m = 1000
    words = [np.full(m, 5, np.int32), np.full(m, -9, np.int32)]
    pay = np.random.default_rng(10).normal(size=m).astype(np.float32)
    vals = words[1:n_keys] + [np.arange(m, dtype=np.int32), pay]
    got, _ = _check(words[0], vals, n_keys)
    np.testing.assert_array_equal(got[-2], np.arange(m))
    np.testing.assert_array_equal(_words(got[-1]), _words(pay))


@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("block", [128, 2048, 8192])
def test_sort_blocks_below_and_above_the_tile(block, n_keys):
    """Blocks sorted inside one CTA of the kernel (below 4,096) and by merge
    passes stopped at the block (above it), against JAX, with one key word
    and with two; the port's order within each block is the stable one."""
    rng = np.random.default_rng(block)
    m = 16384
    words = [rng.integers(-20, 20, size=m).astype(np.int32) for _ in range(2)]
    vals = words[1:n_keys] + [np.arange(m, dtype=np.int32),
                              rng.normal(size=m).astype(np.float32)]
    got = [o.numpy() for o in sort.sort_blocks(
        torch.from_numpy(words[0]), *(torch.from_numpy(v) for v in vals), block=block,
        n_keys=n_keys)]
    want = [np.asarray(o) for o in jax_sort_blocks(
        jnp.asarray(words[0]), *(jnp.asarray(v) for v in vals), block=block, n_keys=n_keys,
        interpret=True)]
    for b in range(0, m, block):
        s = slice(b, b + block)
        for j in range(n_keys):
            np.testing.assert_array_equal(got[j][s], want[j][s])
        np.testing.assert_array_equal(_as_pairs([g[s] for g in got]),
                                      _as_pairs([w[s] for w in want]))
        np.testing.assert_array_equal(
            got[n_keys][s], b + np.lexsort([w[s] for w in words[:n_keys][::-1]]))


@pytest.mark.parametrize("entry", ["sort_pairs", "sort_blocks"])
def test_length_limit(entry):
    """Lengths of 2^30 and more are refused before anything is allocated
    (meta tensors: no memory); 2^30 - 1 passes the length check and stops at
    the device check."""
    fn = getattr(sort, entry)
    kw = {"block": 128} if entry == "sort_blocks" else {}
    with pytest.raises(ValueError, match="below 2"):
        fn(torch.empty(2**30, dtype=torch.int32, device="meta"), **kw)
    with pytest.raises(ValueError, match="device"):
        fn(torch.empty(2**30 - 128, dtype=torch.int32, device="meta"), **kw)
