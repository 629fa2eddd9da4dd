"""train.densify_ms: the epoch driver's own host clock around densify and
prune (its history's ``t_densify``), averaged over the epochs of the window
that densified."""

LAYER = "epoch driver"
MOVES = "train_views_per_s"


def read(run):
    hist = run.data.get("history") or {}
    times = hist.get("t_densify", [])
    vals = [times[e - 1] for e in run.data.get("densify_epochs", []) if e - 1 < len(times)]
    return 1e3 * sum(vals) / len(vals) if vals else None
