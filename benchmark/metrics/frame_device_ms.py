"""frame_device_ms: the device's busy time a request, over every request of
the window: the union of the intervals in which a kernel, a copy or a
memset ran, as the profiler traced the device's activity alone
(``drivers/http_viewer.py::DeviceClock``), over the requests rendered while
it traced. What a frame costs the card, which sets how many frames one card
can serve; its host's time is left out. Untraced runs on a card only."""

LAYER = "device"
MOVES = "frame_device_ms"


def read(run):
    d = run.data.get("device_clock")
    if not d or not d["requests"]:
        return None
    return 1e3 * d["busy_s"] / d["requests"]
