"""The port's spans and counters: off by default, on for a traced run.

Off, :func:`span` and :func:`request` return one shared no-op context
manager, and :func:`count` and :func:`note` return at once: nothing is
allocated, launched on the device or read back.

On (:func:`enable`), a span records its name, the request it belongs to
(None outside one), its parent span, the thread, and its start and end on
``time.perf_counter_ns()``, the clock of ``time.perf_counter``. Records are
kept in memory on the :class:`Tracer` that :func:`enable` returns; a
``sink(name, start_s, end_s)`` also gets each finished span. A request is
opened by :func:`request`, whose record is the request's root. The current
request and span live in thread-local state, so concurrent handler threads
keep theirs apart.

Counters (:func:`count`) and arguments (:func:`note`) belong to the current
request's root record. A tensor counter is kept as a reference and read
once, with the others of its device in one ``torch.stack(...).tolist()``,
when the root closes: after the request's last device wait, so the read adds
no synchronise. Outside a request counters and notes are dropped.

    tracer = trace.enable()
    try:
        ...  # serve
    finally:
        trace.disable()
    tracer.write_chrome("viewer_trace.json")  # Chrome trace events (Perfetto)
"""

import itertools
import json
import os
import threading
import time


class Record:
    """One finished span (times in ``time.perf_counter_ns()``); a request's
    root also holds its ``args`` and ``counters`` (None on other spans)."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns", "end_ns", "args",
                 "counters", "pending")

    def __init__(self, name, id, parent, request, thread, start_ns):
        self.name, self.id, self.parent, self.request = name, id, parent, request
        self.thread, self.start_ns, self.end_ns = thread, start_ns, None
        self.args = self.counters = self.pending = None

    def read_counters(self):
        """Read the pending tensor counters: one stack and one copy to the
        host a device."""
        if not self.pending:
            return
        import torch

        by_device = {}
        for name, t in self.pending:
            by_device.setdefault(t.device, []).append((name, t))
        for items in by_device.values():
            values = torch.stack([t.reshape(()) for _, t in items]).tolist()
            self.counters.update((name, v) for (name, _), v in zip(items, values))
        self.pending = None


class _Local(threading.local):
    """A thread's current span, request id and request root (the class
    attributes are the defaults, so a lookup never raises)."""

    span = request = root = None

    def __init__(self):  # once in each thread that uses it
        self.thread = threading.get_native_id()


class Tracer:
    """The records of one traced stretch of the program."""

    def __init__(self, sink=None):
        self.sink = sink
        self.records = []
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self.local = _Local()

    def finish(self, rec):
        self.records.append(rec)  # one bytecode-level append: safe across threads
        if self.sink is not None:
            self.sink(rec.name, rec.start_ns * 1e-9, rec.end_ns * 1e-9)

    def named(self, name):
        return [r for r in self.records if r.name == name]

    def write_chrome(self, path):
        """Write the records as Chrome trace events ("ph": "X",
        microseconds), the request id and a root's arguments and counters
        in ``args``."""
        pid = os.getpid()
        events = [{"name": r.name, "ph": "X", "ts": r.start_ns / 1e3,
                   "dur": (r.end_ns - r.start_ns) / 1e3, "pid": pid, "tid": r.thread,
                   "args": {"request": r.request, **(r.args or {}), **(r.counters or {})}}
                  for r in sorted(self.records, key=lambda r: r.start_ns)]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


class _Noop:
    """A context manager that does nothing, in C, so that ``with`` makes no
    Python call: ``int`` overrides ``__new__`` and not ``__init__``, so
    ``(0).__init__`` is ``object.__init__``, which then takes any arguments
    and returns None."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod((0).__init__)


NOOP = _Noop()
_tracer = None  # the active Tracer, or None: tracing is off


class _Span:
    __slots__ = ("tracer", "name", "root", "rec", "saved")

    def __init__(self, tracer, name, root):
        self.tracer, self.name, self.root = tracer, name, root

    def __enter__(self):
        t = self.tracer
        local = t.local
        parent, outer_request, outer_root = local.span, local.request, local.root
        req = next(t._requests) if self.root else outer_request
        rec = Record(self.name, next(t._ids), parent.id if parent is not None else None, req,
                     local.thread, time.perf_counter_ns())
        self.saved = (parent, outer_request, outer_root)
        self.rec = local.span = rec
        if self.root:
            rec.args, rec.counters, rec.pending = {}, {}, []
            local.request, local.root = req, rec
        return rec

    def __exit__(self, typ, value, tb):
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        local = self.tracer.local
        local.span, outer_request, outer_root = self.saved
        if self.root:
            local.request, local.root = outer_request, outer_root
            rec.read_counters()
        self.tracer.finish(rec)
        return None


def span(name):
    """A span named ``name`` under the thread's current span."""
    if _tracer is None:
        return NOOP
    return _Span(_tracer, name, False)


def request(name):
    """A request's root span: the spans, counters and notes of the thread
    until it closes belong to a new request id."""
    if _tracer is None:
        return NOOP
    return _Span(_tracer, name, True)


def count(values):
    """Counters {name: int or 0-d tensor} of the current request."""
    if _tracer is None:
        return
    root = _tracer.local.root
    if root is None:
        return
    for name, v in values.items():
        if hasattr(v, "device"):
            root.pending.append((name, v))
        else:
            root.counters[name] = v


def counting():
    """True where :func:`count` keeps what it is given: tracing is on and
    the thread is inside a request. Lets a caller skip making a counter."""
    return _tracer is not None and _tracer.local.root is not None


def note(**args):
    """Arguments of the current request's root record."""
    if _tracer is None:
        return
    root = _tracer.local.root
    if root is not None:
        root.args.update(args)


def enable(sink=None):
    """Turn tracing on; returns the :class:`Tracer` that keeps the records."""
    global _tracer
    _tracer = Tracer(sink)
    return _tracer


def disable():
    """Turn tracing off; returns the tracer that was on, or None."""
    global _tracer
    tracer, _tracer = _tracer, None
    return tracer
