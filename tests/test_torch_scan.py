"""PyTorch port: K3 multi-row cumsum (plain version on the CPU) against the
JAX Pallas scan kernel run through the interpreter, and the wrapper's
input checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from easygaussiansplatting_tpu.ops.pallas import scan as jax_scan
from easygaussiansplatting_tpu_torch.ops.kernels import scan

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

