"""view.frames_per_s: responses completed in the window over the window's
seconds (the window ends when its last request completes), on the host's
clock. The rate a user sees; per layer, as the card's host sets its pace
and its speed drifts between runs (PERF.md §2)."""

from benchmark import stats

LAYER = "whole request"
MOVES = "frame_device_ms"


def read(run):
    if "completed" not in run.data:
        return None
    return stats.rate(run.data["completed"], run.window_s)
