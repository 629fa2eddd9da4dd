"""view.frame_mfu: FP32 operations the profiled requests' frames need over
the profiled stretch's wall time at the chip's FP32 peak outside the tensor
cores (67 TFLOP/s; the render computes in float32): K1 for every gaussian
of the scene and K4 from blend_work on every fifth frame, scaled to all.
The encode's integer work is not counted."""

from benchmark import blend, counting

LAYER = "viewer renderer"
MOVES = "frame_device_ms"


def read(run):
    if run.profile is None or "profile" not in run.data:
        return None
    frames = run.data["profile"]["requests"]
    ops = (frames * counting.k1_ops(run.config["gaussians"])
           + blend.scale(run, "fwd") * sum(counting.k4_ops(w) for w in blend.works(run, "fwd")))
    return 100.0 * ops / (run.profile["window_s"] * counting.FP32_FLOP_PER_S)
