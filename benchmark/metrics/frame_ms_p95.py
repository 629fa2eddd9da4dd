"""frame_ms_p95: the 95th percentile of every request of the window, each
timed at the client from sending the request to its body's last byte."""

from benchmark import stats

LAYER = "benchmark harness"
MOVES = "frame_ms_p95"


def read(run):
    lat = run.data.get("latencies_ms")
    return stats.percentile(lat, 95) if lat else None
