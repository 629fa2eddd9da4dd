"""setup_s: seconds from the process's start to the first timed step or
request, kernel build, scene, ground truth and warm-up included."""

LAYER = "benchmark harness"
MOVES = "setup_s"


def read(run):
    return run.setup_s
