"""view.jpeg_roofline: K11's least time on the profiled frames (the frozen
jpeg_bound on each frame's exact token count and scan bytes) over the
device time of K11's four kernels on the same frames (every fifth of the
profiled stretch; K11 launches four kernels a frame, in order)."""

from benchmark import blend, counting
from benchmark.reference import jpeg

LAYER = "JPEG kernel (K11)"
MOVES = "frame_device_ms"
NAMES = ("jpeg_blocks_kernel", "jpeg_lengths_kernel", "jpeg_pack_kernel", "jpeg_stuff_kernel")


def read(run):
    if run.profile is None or "profile" not in run.data:
        return None
    each = run.profile["each"]
    frames = run.data["profile"]["frames"]
    device_s = sum(sum(each.get(n, [])[::blend.STRIDE]) for n in NAMES)
    if device_s <= 0 or not frames:
        return None
    clock, n_sm = blend.chip()
    quality = run.config["jpeg_quality"]
    bound_ms = 0.0
    for rgb, body in frames:
        h, w, _ = rgb.shape
        scan = len(body) - len(jpeg.headers(w, h, quality)) - len(jpeg.EOI)
        bound_ms += counting.jpeg_bound(h, w, jpeg.coefficients(rgb, quality), scan, clock,
                                        n_sm)["bound_ms"]
    return 100.0 * bound_ms / (1e3 * device_s)
