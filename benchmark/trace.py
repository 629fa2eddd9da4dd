"""Host spans and the profiled window of a ``--trace 1`` run.

:class:`Spans` keeps named host intervals (``time.perf_counter`` seconds)
in memory. :class:`Profile` runs ``torch.profiler`` over a window of the
timed path and reduces it: device time by kernel name, the device's busy
seconds (the union of its kernel, copy and set intervals), and the longest
idle gaps labelled by the innermost host span that covers them. It checks
each port kernel's records against its wrapper's launch counter, as the
program's smoke run does: a window that lost a record gives no device
numbers (profile windows have been seen to drop records on this card).
"""

import threading
import time

GAP_MIN_S = 1e-5  # idle intervals shorter than this are launch jitter, not gaps


class Spans:
    """Named host intervals, kept in memory; thread-safe."""

    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    def add(self, name, start, end):
        with self._lock:
            self.items.append((name, start, end))

    def span(self, name):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                spans.add(name, self.t0, time.perf_counter())
                return False

        return _Span()

    def named(self, name):
        return [(s, e) for n, s, e in self.items if n == name]


class Keeper:
    """Stands in for a kernel wrapper under its module name: calls it and
    keeps the arguments and result of every ``stride``-th call. The wrapper
    counts its launches under that name, so ``launches`` reads and writes
    the wrapper's."""

    def __init__(self, fn, stride):
        self.fn, self.stride = fn, stride
        self.calls, self.n = [], 0

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.n % self.stride == 0:
            self.calls.append((tuple(a.detach() if hasattr(a, "detach") else a for a in args),
                               kwargs, out))
        self.n += 1
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


def short_name(name):
    """A device kernel's name without return type, namespaces, template
    arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split(" ")[-1].split("::")[-1][-60:]


def union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(spans, t):
    """The innermost span around host time ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "outside any span"


class Profile:
    """One profiled window. ``groups`` maps a port kernel's label to (its
    device kernel names, its wrapper, kernels a launch). Call :meth:`start`
    and :meth:`stop` at points where the device is idle (after a
    synchronise); ``spans`` label the gaps."""

    def __init__(self, groups, spans):
        self.groups = groups
        self.spans = spans
        self.prof = None
        self.result = None
        self.lost = None

    def start(self):
        import torch

        torch.cuda.synchronize()
        self._launches = {k: w.launches for k, (_, w, _) in self.groups.items()}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        with torch.profiler.record_function("bench_align"):
            self._align = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.launched = {k: w.launches - self._launches[k]
                         for k, (_, w, _) in self.groups.items()}

    def reduce(self):
        """The window's numbers, or None where the profiler traced no device
        work or lost records: {"window_s", "busy_s", "by_name" (seconds by
        kernel name), "gaps" ([label, seconds] longest first),
        "launched", "records"}."""
        import torch

        events = self.prof.events()
        align = [e for e in events if e.name == "bench_align"]
        dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        if not dev or not align:
            self.lost = "the profiler traced no device work"
            return None
        records = {k: sum(short_name(e.name) in names for e in dev) // per
                   for k, (names, _, per) in self.groups.items()}
        if records != self.launched:
            self.lost = ", ".join(f"{k} {records[k]} of {self.launched[k]}" for k in records
                                  if records[k] != self.launched[k])
            return None
        # profiler times are microseconds from its own origin; the marker
        # ties them to the host clock
        origin = self._align - align[0].time_range.start * 1e-6
        iv = [(origin + e.time_range.start * 1e-6, origin + e.time_range.end * 1e-6) for e in dev]
        by_name, each = {}, {}
        for e in sorted(dev, key=lambda e: e.time_range.start):
            n = short_name(e.name)
            by_name[n] = by_name.get(n, 0.0) + e.time_range.elapsed_us() * 1e-6
            each.setdefault(n, []).append(e.time_range.elapsed_us() * 1e-6)
        busy = union(iv)
        busy_s = sum(e - s for s, e in busy)
        edges = [self.t0] + [x for s, e in busy for x in (s, e)] + [self.t1]
        spans = [(n, a, b) for n, a, b in self.spans.items if b >= self.t0 and a <= self.t1]
        gaps = []
        for i in range(0, len(edges) - 1, 2):
            s, e = max(edges[i], self.t0), min(edges[i + 1], self.t1)
            if e - s >= GAP_MIN_S:
                gaps.append((_label(spans, 0.5 * (s + e)), e - s))
        self.result = {"window_s": self.t1 - self.t0, "busy_s": busy_s, "by_name": by_name,
                       "each": each, "gaps": gaps, "launched": self.launched,
                       "records": records}
        return self.result

    def kernel_s(self, names):
        return sum(v for n, v in self.result["by_name"].items() if n in names)


def breakdown(result, top=10):
    """The traced run's breakdown: the device operations that took most
    time, and the idle gaps summed by what the host was doing, longest
    first (seconds, as measured)."""
    ops = sorted(result["by_name"].items(), key=lambda kv: -kv[1])[:top]
    by_label = {}
    for label, s in result["gaps"]:
        by_label[label] = by_label.get(label, 0.0) + s
    gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}
