"""train.step_mfu: FP32 operations the profiled steps need over their wall
time at the chip's FP32 peak outside the tensor cores (67 TFLOP/s; the step
computes in float32). The operations are counted from the frozen
arithmetic on the same steps' inputs: K1 and K2 for the alive gaussians,
K4 and K5 from blend_work on every fifth step, scaled to all, the loss with
separable blurs, Adam on the alive gaussians' parameters."""

from benchmark import blend, counting

LAYER = "train step"
MOVES = "train_views_per_s"


def read(run):
    if run.profile is None or "profile" not in run.data:
        return None
    pr = run.data["profile"]
    steps, alive = pr["steps"], pr["n_alive"]
    per_step = (counting.k1_ops(alive) + counting.K2_OPS_GAUSSIAN * alive
                + counting.loss_ops(run.data["width"] * run.data["height"])
                + alive * counting.PARAM_COLS * counting.ADAM_OPS_ELEMENT)
    ops = (steps * per_step
           + blend.scale(run, "fwd") * sum(counting.k4_ops(w) for w in blend.works(run, "fwd"))
           + blend.scale(run, "bwd") * sum(counting.k5_ops(w) for w in blend.works(run, "bwd")))
    return 100.0 * ops / (run.profile["window_s"] * counting.FP32_FLOP_PER_S)
