"""train.rasterize_bwd_roofline: K5's least time on the profiled steps'
inputs (the frozen k5_bound on blend_work's counts) over the same calls'
profiled device time."""

from benchmark import blend

LAYER = "blend kernels (K4, K5)"
MOVES = "train_views_per_s"


def read(run):
    if run.profile is None or "profile" not in run.data:
        return None
    device_s = blend.device_s(run, "bwd")
    if device_s <= 0:
        return None
    bound_ms = sum(b["bound_ms"] for b in blend.k5_bounds(run))
    return 100.0 * bound_ms / (1e3 * device_s)
