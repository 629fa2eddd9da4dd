"""view.rasterize_fwd_roofline: K4's least time on the profiled frames'
inputs (the frozen k4_bound on blend_work's counts) over the same calls'
profiled device time."""

from benchmark import blend

LAYER = "blend kernels (K4, K5)"
MOVES = "frame_device_ms"


def read(run):
    if run.profile is None or "profile" not in run.data:
        return None
    device_s = blend.device_s(run, "fwd")
    bounds = blend.k4_bounds(run)
    if device_s <= 0 or not bounds:
        return None
    return 100.0 * sum(b["bound_ms"] for b in bounds) / (1e3 * device_s)
