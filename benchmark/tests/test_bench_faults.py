"""``correct`` has to come out false on a broken timed path: each cell's run
driven on the CPU at a tiny size (the harness's look for a chip skipped),
with a fault planted in the program underneath, and with the control (the
reference one precision below the configuration's, in the program's
place). The training control needs TF32, which only the card has."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.test_bench_harness import tiny_cell

SEED = 2**31 + 11


def run_tiny(tmp_path, kind, undo=None, seconds=2.0):
    cell, root, bench = tiny_cell(tmp_path, kind)
    try:
        return harness.run_cell(cell, SEED, seconds, False, 0.0, root=root, bench=bench,
                                device="cpu")
    finally:
        if undo is not None:
            undo()


@pytest.mark.parametrize("fault", ["unchanged", "double_update", "half_batch",
                                   "answer_altered"])
def test_training_fault_is_not_correct(tmp_path, fault):
    run, line = run_tiny(tmp_path, "train", control.train_faults()[fault](), seconds=5.0)
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.parametrize("kind", ["short_drags", "drag_preview"])
@pytest.mark.parametrize("fault", ["stale_frame", "half_frame", "tile_column", "answer_altered"])
def test_viewer_fault_is_not_correct(tmp_path, kind, fault):
    run, line = run_tiny(tmp_path, kind, control.view_faults()[fault]())
    assert line["correct"] is False, (fault, line["checks"])
    if fault == "tile_column":  # a fault of a few tiles: the worst MCU's share sees it
        mcu = line["checks"]["mcu_mismatch"]
        assert mcu["value"] > mcu["limit"], line["checks"]


@pytest.mark.parametrize("kind", ["short_drags", "drag_preview"])
def test_viewer_control_is_not_correct(tmp_path, kind):
    cell, root, bench = tiny_cell(tmp_path, kind)
    cfg = harness.load_data("configs", "tiny_view", bench)
    undo = control.view_control(cfg, device="cpu")
    try:
        run, line = harness.run_cell(cell, SEED, 2.0, False, 0.0, root=root, bench=bench,
                                     device="cpu")
    finally:
        undo()
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
def test_training_control_is_not_correct(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the control is TF32, which needs the card")
    cell, root, bench = tiny_cell(tmp_path, "train")
    cfg = harness.load_data("configs", "tiny_train", bench)
    limits = harness.load_data("workloads", cell, bench)["limits"]
    nums = control.train_control(cfg, SEED, device="cuda")
    assert any(nums[k] > limits[k] for k in limits if k in nums), nums
