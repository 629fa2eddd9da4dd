"""view.render_ms: median over the window's requests of the host clock
around SceneRenderer.render_device, ending in a synchronise (traced run)."""

import statistics

LAYER = "viewer renderer"
MOVES = "frame_device_ms"


def read(run):
    spans = run.spans.named("render_device")[run.data.get("spans_skip", 0):]
    return 1e3 * statistics.median(e - s for s, e in spans) if spans else None
