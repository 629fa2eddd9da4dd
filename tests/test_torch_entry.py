"""PyTorch port: the entry points of graft_entry.py, bench_scaling and the
train CLI's multi-device flags on the CPU: entry() against the JAX
package's, dryrun_multichip over 2 gloo ranks, every entry point's refusal
of a CUDA request without a card, and the train CLI's --batch run in one
process and in two (--coordinator/--num-processes/--process-id)."""

import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from easygaussiansplatting_tpu_torch import bench_scaling
from easygaussiansplatting_tpu_torch.graft_entry import dryrun_multichip, entry
from easygaussiansplatting_tpu_torch.parallel.distributed import (
    free_port,
    init_distributed,
    launch_ranks,
)
from easygaussiansplatting_tpu_torch.train.__main__ import main as train_main

ROOT = Path(__file__).resolve().parents[1]
CLI = ["--synthetic", "--epochs", "1", "--batch", "2", "--mesh-data", "1", "--device", "cpu"]

torch.set_num_threads(2)


def test_entry_matches_jax_entry():
    """The forward render of 2,048 gaussians at 256x192 (the JAX side on its
    Pallas backend in interpret mode, the port on its plain path)."""
    jfn, jargs = jax_entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = entry(device="cpu")
    assert all(a.dtype == torch.float32 for a in args)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
    got = fn(*args).detach().numpy()
    assert got.shape == (3, 192, 256)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_dryrun_multichip_on_two_gloo_ranks():
    reports = dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["mesh"] == [1, 2] for r in reports)
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["banded_loss"]) for r in reports)
    # every rank returns the same reduced loss and drops
    assert len({(r["loss"], r["banded_loss"], r["dropped"]) for r in reports}) == 1


@pytest.mark.parametrize("call", [
    lambda tmp: train_main(["--synthetic", "--epochs", "1", "--device", "cuda", "--out",
                            str(tmp)]),
    lambda tmp: train_main(CLI[:-1] + ["cuda", "--out", str(tmp)]),
    lambda tmp: entry(),
    lambda tmp: dryrun_multichip(1),
    lambda tmp: bench_scaling.main(["--steps", "1", "--trials", "1"]),
    lambda tmp: init_distributed(f"localhost:{free_port()}", 1, 0),
], ids=["train", "train --batch", "entry", "dryrun_multichip", "bench_scaling",
        "init_distributed"])
def test_cuda_request_without_a_card_raises(call, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        call(tmp_path / "out")
    assert not (tmp_path / "out").exists()  # nothing ran on the CPU instead
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def one_process_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    hist = train_main(CLI + ["--out", str(out)])
    return out, hist


def test_train_cli_batch_writes_final(one_process_run):
    out, hist = one_process_run
    assert (out / "final.npy").exists() and (out / "final.ply").exists()
    assert (out / "checkpoint.npz").exists()
    assert hist["overflow_steps"] == [0] and len(hist["loss"]) == 1
    assert np.isfinite(hist["loss"]).all()


def test_train_cli_two_processes_match_one(one_process_run, tmp_path):
    """Two gloo ranks on the mesh (data 1, gs 2): rank 0 writes one
    final.npy (rank 1, pointed at another directory, writes nothing),
    within test_parallel.py's parameter limit (3e-5) of the one-process
    batched run's."""
    one, _ = one_process_run
    port = free_port()
    outs = [tmp_path / "r0", tmp_path / "r1"]
    printed = launch_ranks(
        lambda r: [sys.executable, "-m", "easygaussiansplatting_tpu_torch.train", *CLI,
                   "--coordinator", f"localhost:{port}", "--num-processes", "2",
                   "--process-id", str(r), "--out", str(outs[r])],
        2, 300, env={**os.environ, "OMP_NUM_THREADS": "1"}, cwd=ROOT)
    assert "mesh {'data': 1, 'gs': 2}; batch=2" in printed[0]
    assert printed[1].strip() == ""  # only rank 0 narrates
    assert not outs[1].exists()
    got, want = np.load(outs[0] / "final.npy"), np.load(one / "final.npy")
    assert got.dtype == want.dtype and got.shape == want.shape
    for k in want.dtype.names:
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, err_msg=k)


def test_bench_scaling_on_virtual_ranks(capsys):
    """--virtual 2: world sizes 1 and 2 of gloo ranks on the CPU, the JAX
    script's JSON keys."""
    out = bench_scaling.main(["--virtual", "2", "--width", "32", "--height", "32",
                              "--gaussians", "64", "--steps", "1", "--trials", "1"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in printed[:2]] == ["devices=", "devices="]
    assert json.loads(printed[-1]) == out
    assert out["metric"] == "scaling_efficiency" and out["unit"] == "fraction at 2 devices"
    assert out["value"] > 0 and "vs_baseline" in out
