"""view.frame_ms_p95: the 95th percentile of every request of the window,
each timed at the client from sending the request to its body's last byte.
The tail a user sees; per layer, as the card's host sets it and its speed
drifts between runs (PERF.md §2)."""

from benchmark import stats

LAYER = "whole request"
MOVES = "frame_device_ms"


def read(run):
    lat = run.data.get("latencies_ms")
    return stats.percentile(lat, 95) if lat else None
