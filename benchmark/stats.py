"""The arithmetic of the end-to-end metrics: a percentile over every request,
a rate over the whole window, and the time a curve first crosses a target;
and of a set of runs: its spread, and its quartile spread."""

import math
import statistics


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


def spread(values):
    """A set of runs' spread: the range of the runs, leaving out the run
    farthest from their median where that narrows it, over the median. A
    metric whose runs spread by more than half its bound cannot tell a
    change from noise."""
    xs = sorted(values)
    med = statistics.median(xs)
    if len(xs) > 2:
        far = 0 if med - xs[0] > xs[-1] - med else -1
        xs.pop(far)
    return (xs[-1] - xs[0]) / med


def quartile_spread(values):
    """The distance between the first and third quartiles over the median,
    as ``statistics.quantiles(values, n=4)`` places them: the spread behind
    a bound (five times the widest, at most 0.25)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
