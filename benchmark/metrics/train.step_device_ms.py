"""train.step_device_ms: device busy time a training step, from the
profiled stretch of steps (the union of the device's kernel, copy and set
intervals, over the steps profiled)."""

LAYER = "train step"
MOVES = "train_views_per_s"


def read(run):
    if run.profile is None or "profile" not in run.data:
        return None
    return 1e3 * run.profile["busy_s"] / run.data["profile"]["steps"]
