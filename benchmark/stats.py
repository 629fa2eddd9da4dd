"""The arithmetic of the end-to-end metrics: a percentile over every request,
a rate over the whole window, and the time a curve first crosses a target."""

import math


def percentile(values, q):
    """The ``q``-th percentile (0..100) of every value, linearly
    interpolated between order statistics (numpy's default rule)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count, window_s):
    """Work completed per second over the whole window."""
    if window_s <= 0:
        raise ValueError("empty window")
    return count / window_s


def crossing_time(points, target, window_s):
    """The time at which a rising curve first reaches ``target``: ``points``
    are (time, value) in time order, the time linearly interpolated between
    the last point below and the first at or above the target. Where no
    point reaches it, the window's length."""
    prev = None
    for t, v in points:
        if v >= target:
            if prev is None or prev[1] >= v:
                return t
            t0, v0 = prev
            return t0 + (target - v0) / (v - v0) * (t - t0)
        prev = (t, v)
    return window_s
