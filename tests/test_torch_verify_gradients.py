"""PyTorch port: the gradient gate (easygaussiansplatting_tpu_torch/
verify_gradients.py) on the CPU: 29 [OK] lines and exit code 0, one line
naming the 7 checks that need the card, and exit code 1 when a stage's
gradient is planted wrong."""

import re

import pytest
import torch

from easygaussiansplatting_tpu_torch import verify_gradients
from easygaussiansplatting_tpu_torch.ops import stages

torch.set_num_threads(2)


def _verdicts(text):
    return re.findall(r"\[(OK|NG)\]", text)


def test_gate_passes_29_checks_on_cpu(capsys):
    assert verify_gradients.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _verdicts(out) == ["OK"] * 29
    first = out.splitlines()[0]
    assert first.startswith("not run on device cpu") and "7 checks" in first
    assert "ALL OK" in out


class _Negated(torch.autograd.Function):
    """Identity forward, negated gradient: a planted fault in a VJP."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return -g


@pytest.mark.parametrize("stage", ["compute_cov3d", "inverse_cov2d"])
def test_gate_refuses_a_negated_stage_gradient(monkeypatch, capsys, stage):
    real = getattr(stages, stage)

    def faulty(*args, **kw):
        out = real(*args, **kw)
        return (_Negated.apply(out[0]), *out[1:]) if isinstance(out, tuple) else _Negated.apply(out)

    monkeypatch.setattr(stages, stage, faulty)
    assert verify_gradients.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "NG" in _verdicts(out) and "FAILURES PRESENT" in out
