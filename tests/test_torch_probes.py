"""PyTorch port: the K9 and K10 probes (probes/micro_bench.py,
probes/exp_dma_stream.py) against the Pallas kernels of scripts/micro_bench.py
and scripts/exp_dma_stream.py, run through the Pallas interpreter on the same
numpy inputs; the wrappers' input checks; the probes' entry points at small
sizes."""

import importlib.util
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from easygaussiansplatting_tpu_torch.probes import exp_dma_stream, micro_bench

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def jax_micro_bench(monkeypatch):
    """scripts/micro_bench.py with its pallas_call run by the interpreter."""
    mod = _script("micro_bench")
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    shim.pallas_call = partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(mod, "pl", shim)
    return mod


def _inputs(q, n_tiles, seed, skip=()):
    """packed [16, q*256] and non-decreasing tiles; the tiles in ``skip`` get
    no chunk."""
    rng = np.random.default_rng(seed)
    packed = rng.normal(size=(16, q * 256)).astype(np.float32)
    pool = [t for t in range(n_tiles) if t not in skip]
    tiles = np.sort(rng.choice(pool, size=q)).astype(np.int32)
    return packed, tiles


# (q, n_tiles, seed, tiles no chunk visits); the last two put 40 chunks in
# one tile, alone or between two empty tiles
CASES = [(12, 5, 0, ()), (40, 9, 1, (3, 8)), (40, 1, 2, ()), (40, 3, 2, (0, 2))]


@pytest.mark.parametrize("q,n_tiles,seed,skip", CASES)
def test_variant_a_matches_interpreted_pallas(jax_micro_bench, q, n_tiles, seed, skip):
    packed, tiles = _inputs(q, n_tiles, seed, skip)
    want = np.asarray(jax_micro_bench.variant_a(q, jnp.asarray(packed), jnp.asarray(tiles)))
    got = micro_bench.variant_a(q, torch.from_numpy(packed), torch.from_numpy(tiles))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q,n_tiles,seed,skip", CASES)
def test_variant_b_matches_interpreted_pallas_and_add_at(jax_micro_bench, q, n_tiles, seed, skip):
    """The TPU kernel defines only tiles[0]'s block (the others start from
    whatever the buffer held: NaN in the interpreter); there the port is
    equal to it. Every tile is equal to np.add.at in float32, which adds the
    chunks in index order as the port does."""
    packed, tiles = _inputs(q, n_tiles, seed, skip)
    img_j, tau_j = jax_micro_bench.variant_b(q, n_tiles, jnp.asarray(packed), jnp.asarray(tiles))
    img, tau = micro_bench.variant_b(q, n_tiles, torch.from_numpy(packed),
                                     torch.from_numpy(tiles))
    t0 = int(tiles[0])
    np.testing.assert_array_equal(img[t0].numpy(), np.asarray(img_j)[t0])
    np.testing.assert_array_equal(tau[t0].numpy(), np.asarray(tau_j)[t0])
    want = np.zeros((n_tiles, 3, 256), np.float32)
    np.add.at(want, tiles, packed[:3].reshape(3, q, 256).transpose(1, 0, 2))
    np.testing.assert_array_equal(img.numpy(), want)
    assert tau.shape == (n_tiles, 256, 1) and bool((tau == 1).all())
    for t in skip:
        assert not img[t].any()


@pytest.mark.parametrize("q,n_tiles,seed,skip", CASES)
def test_variant_vmem_resident_matches_interpreted_pallas(jax_micro_bench, q, n_tiles, seed,
                                                          skip):
    """Both sum each chunk's 256 pixels, then the chunks in order, but XLA
    and torch sum the pixels in different orders: float32 sums of n terms
    differ by up to ~log2(n) * 2^-24 of the sum of |x| (5e-7 for 256), held
    at 1e-6 of each tile's sum of |x| (~1e-3 abs here; the values are ~50,
    a few ulp apart)."""
    packed, tiles = _inputs(q, n_tiles, seed, skip)
    want = np.asarray(jax_micro_bench.variant_vmem_resident(
        q, n_tiles, jnp.asarray(packed), jnp.asarray(tiles)))
    got = micro_bench.variant_vmem_resident(q, n_tiles, torch.from_numpy(packed),
                                            torch.from_numpy(tiles))
    assert got.shape == (n_tiles, 3)
    mag = np.zeros((n_tiles, 3))
    np.add.at(mag, tiles, np.abs(packed[:3].reshape(3, q, 256)).sum(2).T)
    assert (np.abs(got.numpy() - want) <= 1e-6 * mag).all()
    assert not got[list(skip)].any()


def _jax_stream_sums(offs, rows, x):
    """scripts/exp_dma_stream.py's kernel under the interpreter, with the
    grid spec of its main (:58-68) at these sizes."""
    mod = _script("exp_dma_stream")
    q = offs.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(q,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec((1, 1, 16), lambda i, *_: (i, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, mod.K, 16), jnp.float32), pltpu.SemaphoreType.DMA((2,))],
    )
    out = pl.pallas_call(mod.kernel, grid_spec=grid_spec, interpret=True,
                         out_shape=jax.ShapeDtypeStruct((q, 1, 16), jnp.float32))(
        jnp.asarray(offs), jnp.asarray(rows), jnp.asarray(x))
    return np.asarray(out)


def test_stream_sums_matches_interpreted_pallas():
    """float32 sums of up to 128 N(0, 1) rows in another order: within 1e-5
    abs."""
    x, offs, rows = exp_dma_stream.make_inputs(m=4096, q_total=24)
    rows[:2] = (1, 128)  # both ends of the row count
    want = _jax_stream_sums(offs, rows, x)
    got = exp_dma_stream.stream_sums(torch.from_numpy(offs), torch.from_numpy(rows),
                                     torch.from_numpy(x))
    assert got.shape == (24, 1, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [1, 128])
@pytest.mark.parametrize("end", ["first rows", "last rows"])
def test_stream_sums_at_the_ends_of_x_matches_interpreted_pallas(end, n):
    """Chunks of 1 and of 128 rows that start at row 0 or end at row m - 1:
    within 1e-5 abs, as above."""
    x, offs, rows = exp_dma_stream.make_inputs(m=1024, q_total=6)
    offs[:3] = 0 if end == "first rows" else 1024 - 128
    rows[:3] = n
    want = _jax_stream_sums(offs, rows, x)
    got = exp_dma_stream.stream_sums(torch.from_numpy(offs), torch.from_numpy(rows),
                                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if end == "last rows" and n == 128:
        np.testing.assert_allclose(got.numpy()[0, 0], x[-128:].sum(0), atol=1e-5, rtol=0)


def _bad_k9(case):
    packed, tiles = _inputs(12, 5, 0)
    packed, tiles = torch.from_numpy(packed), torch.from_numpy(tiles)
    if case == "unsorted tiles":
        tiles = tiles.flip(0).contiguous()
    elif case == "tile past n_tiles":
        tiles[-1] = 5
    elif case == "negative tile":
        tiles[0] = -1
    elif case == "tiles int64":
        tiles = tiles.long()
    elif case == "packed too narrow":
        packed = packed[:, :-256].contiguous()
    return packed, tiles


@pytest.mark.parametrize("case", ["unsorted tiles", "tile past n_tiles", "negative tile",
                                  "tiles int64", "packed too narrow"])
@pytest.mark.parametrize("variant", ["b", "vmem_resident"])
def test_k9_wrappers_refuse_bad_inputs(case, variant):
    packed, tiles = _bad_k9(case)
    fn = getattr(micro_bench, f"variant_{variant}")
    with pytest.raises(ValueError):
        fn(12, 5, packed, tiles)


def test_k9a_refuses_unsorted_tiles():
    packed, tiles = _bad_k9("unsorted tiles")
    with pytest.raises(ValueError, match="non-decreasing"):
        micro_bench.variant_a(12, packed, tiles)


@pytest.mark.parametrize("case", ["rows 0", "rows 129", "offs past the end", "negative offs",
                                  "x too short", "x 8 columns", "rows int64"])
def test_k10_wrapper_refuses_bad_inputs(case):
    x, offs, rows = exp_dma_stream.make_inputs(m=1024, q_total=8)
    x, offs, rows = (torch.from_numpy(a) for a in (x, offs, rows))
    if case == "rows 0":
        rows[3] = 0
    elif case == "rows 129":
        rows[3] = 129
    elif case == "offs past the end":
        offs[5] = 1024 - 127
    elif case == "negative offs":
        offs[0] = -1
    elif case == "x too short":
        x = x[:127].contiguous()
    elif case == "x 8 columns":
        x = x[:, :8].contiguous()
    elif case == "rows int64":
        rows = rows.long()
    with pytest.raises(ValueError):
        exp_dma_stream.stream_sums(offs, rows, x)


def test_micro_bench_run_on_cpu(capsys):
    """The probe's entry point at a small size: one ``label ms`` line per
    variant and per D step."""
    out = micro_bench.run("cpu", q_total=64, n_tiles=24, n=512, max_patches=4096)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(lines) == 10
    assert [ln.split(":")[0] for ln in lines] == ["A", "B", "V", "D1", "D2", "D3a", "D3b",
                                                  "D3c", "D4", "D5"]
    assert all(ln.endswith(" ms") and v >= 0 for ln, v in zip(lines, out.values()))


def test_exp_dma_stream_main_exits_nonzero_on_fail(monkeypatch, capsys):
    monkeypatch.setattr(exp_dma_stream, "run", partial(exp_dma_stream.run, m=2048, q_total=64))
    assert exp_dma_stream.main(["--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out
    plain = exp_dma_stream.stream_sums_plain
    monkeypatch.setattr(exp_dma_stream, "stream_sums",
                        lambda o, r, x: plain(o, r, x) + 2e-3)  # a planted fault
    assert exp_dma_stream.main(["--device", "cpu"]) == 1
    assert "FAIL" in capsys.readouterr().out
