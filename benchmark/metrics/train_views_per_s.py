"""train_views_per_s: training steps (one view each) completed in the
window over the window's seconds; densify, alpha reset and eval inside."""

from benchmark import stats

LAYER = "benchmark harness"
MOVES = "train_views_per_s"


def read(run):
    if "steps" not in run.data:
        return None
    return stats.rate(run.data["steps"], run.window_s)
