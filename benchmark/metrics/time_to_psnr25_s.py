"""time_to_psnr25_s: wall seconds from the window's start to the moment the
mean eval PSNR over the eval views first reaches the target (25 dB),
linearly interpolated between the end-of-epoch evals on either side of it;
the window's length where it is not reached. Evals are inside the window."""

from benchmark import stats

LAYER = "benchmark harness"
MOVES = "time_to_psnr25_s"


def read(run):
    if "evals" not in run.data:
        return None
    return stats.crossing_time(run.data["evals"], run.data["target_psnr"], run.window_s)
