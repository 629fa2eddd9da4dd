"""PyTorch port: the train and bench CLIs in a subprocess on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from easygaussiansplatting_tpu.data.gau_io import load_gs as jax_load_gs

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _run(*args):
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=ENV)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_train_cli_writes_its_files_and_resumes(tmp_path):
    """The JAX CLI's synthetic scene (512 gaussians, 8 views, 128x96) for
    one epoch, then --resume for a second."""
    out = _run("easygaussiansplatting_tpu_torch.train", "--synthetic", "--epochs", "1",
               "--device", "cpu", "--out", str(tmp_path))
    assert "[epoch 1] loss=" in out
    for name in ("final.ply", "final.npy", "checkpoint.npz", "epoch0001.npy"):
        assert (tmp_path / name).exists(), name
    ply = jax_load_gs(tmp_path / "final.ply")  # the official layout, read by the JAX package
    assert len(ply) == 512 and np.isfinite(ply["pw"]).all()
    out = _run("easygaussiansplatting_tpu_torch.train", "--synthetic", "--epochs", "2",
               "--device", "cpu", "--out", str(tmp_path), "--resume",
               str(tmp_path / "checkpoint.npz"))
    assert "resumed from" in out and "at epoch 1" in out
    assert "[epoch 2] loss=" in out and "[epoch 1] loss=" not in out
    assert (tmp_path / "epoch0002.npy").exists()
    with np.load(tmp_path / "checkpoint.npz") as z:
        assert int(z["meta/epoch"]) == 2 and "meta/torch_rng" in z


def test_bench_cli_prints_one_json_line():
    out = _run("easygaussiansplatting_tpu_torch.bench", "--device", "cpu")
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "fwd_bwd_throughput" and rec["unit"] == "Mpix/s"
    assert rec["device"] == "cpu"
    for k in ("value", "vs_baseline", "fwd_throughput"):
        assert rec[k] > 0, k
