"""frames_per_s: responses completed in the window over the window's
seconds (the window ends when its last request completes)."""

from benchmark import stats

LAYER = "benchmark harness"
MOVES = "frames_per_s"


def read(run):
    if "completed" not in run.data:
        return None
    return stats.rate(run.data["completed"], run.window_s)
