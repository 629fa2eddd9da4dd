"""view.device_idle_share: the share of the profiled requests' wall time in
which no operation ran on the device (HTTP, the client and host work
between the renders count as idle)."""

LAYER = "device"
MOVES = "frame_device_ms"


def read(run):
    if run.profile is None or "profile" not in run.data:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
