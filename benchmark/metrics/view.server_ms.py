"""view.server_ms: median over the window's requests of the client's
latency less the request's render_device and encode spans: the HTTP
server's and the client's host path. Requests are serial, so the spans pair
with the requests in order (traced run)."""

import statistics

LAYER = "HTTP server"
MOVES = "frame_device_ms"


def read(run):
    skip = run.data.get("spans_skip", 0)
    render = run.spans.named("render_device")[skip:]
    encode = run.spans.named("encode_jpeg")[skip:]
    lat = run.data.get("latencies_ms", [])
    n = min(len(render), len(encode), len(lat))
    if not n:
        return None
    return statistics.median(lat[i] - 1e3 * ((render[i][1] - render[i][0])
                                             + (encode[i][1] - encode[i][0])) for i in range(n))
