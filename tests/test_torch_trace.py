"""PyTorch port: the tracer (utils/trace.py) and its spans and counters in
the web viewer. Off, it keeps nothing and allocates nothing; on, spans nest
with their parents and requests, concurrent handler threads keep their
request ids apart, tensor counters are read once when the request closes,
and a served /render gives viewer.request > render > (render.wait,
render.preprocess, render.binning, render.blend) and encode.launch, with
binning's counters equal to a direct render's and K4's beside them. ``gaussian_viewer --serve
--trace PATH`` writes Chrome trace events and reports drops at exit."""

import json
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu_torch.data import example_gaussians
from easygaussiansplatting_tpu_torch.ops.kernels.jpeg import encode_jpeg
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.utils import trace
from easygaussiansplatting_tpu_torch.viewer.server import SceneRenderer, serve

torch.set_num_threads(2)

VIEW = dict(azimuth=0.7, elevation=0.3, width=64, height=48)
QUERY = "/render?az=0.7&el=0.3&w=64&h=48"
RENDER_CHILDREN = {"render.wait", "render.preprocess", "render.binning", "render.blend"}
BINNING = ("binning.patches", "binning.dropped", "binning.rows", "binning.rows_dropped",
           "binning.slots", "binning.kernel")
BLEND = ("blend.items", "blend.items_skipped", "blend.rewalked")


@pytest.fixture()
def tracer():
    tr = trace.enable()
    try:
        yield tr
    finally:
        trace.disable()


def _gaussians():
    g = example_gaussians()
    return {k: g[k] for k in ("pws", "rots", "scales", "alphas", "shs")}


def test_off_keeps_nothing(monkeypatch):
    assert trace.disable() is None
    assert trace.span("render") is trace.NOOP
    assert trace.request("viewer.request") is trace.NOOP
    with trace.span("render") as s:
        assert s is None
    with pytest.raises(ValueError):  # the no-op lets an exception through
        with trace.span("render"):
            raise ValueError("raised inside a span")

    def never(*args, **kwargs):
        raise AssertionError("tracing is off: nothing may be recorded")

    monkeypatch.setattr(trace, "_Span", never)
    monkeypatch.setattr(trace, "Record", never)
    renderer = SceneRenderer(_gaussians(), device="cpu")
    frame = renderer.render_device(**VIEW)
    assert encode_jpeg(frame)[:2] == b"\xff\xd8"
    assert trace.count({"binning.patches": torch.tensor(3)}) is None
    assert trace.note(path="/render") is None


def test_spans_nest_with_parents_and_request(tracer):
    sunk = []
    tracer.sink = lambda *a: sunk.append(a)
    t0 = time.perf_counter()
    with trace.span("before"):
        pass
    with trace.request("root") as root:
        with trace.span("a") as a:
            with trace.span("b") as b:
                pass
        with trace.span("c") as c:
            pass
    t1 = time.perf_counter()
    by = {r.name: r for r in tracer.records}
    assert [r.name for r in tracer.records] == ["before", "b", "a", "c", "root"]
    assert by["before"].request is None and by["before"].parent is None
    assert root.parent is None and root.request == a.request == b.request == c.request
    assert (a.parent, b.parent, c.parent) == (root.id, a.id, root.id)
    assert len({r.thread for r in tracer.records}) == 1
    assert root.start_ns <= a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns
    assert c.end_ns <= root.end_ns
    # the sink gets each finished span in seconds on time.perf_counter's clock
    assert [s[0] for s in sunk] == ["before", "b", "a", "c", "root"]
    assert all(t0 <= s <= e <= t1 for _, s, e in sunk)
    with trace.span("after") as after:
        pass
    assert after.request is None and after.parent is None


def test_concurrent_requests_keep_ids_apart(tracer):
    """More threads than cores, switching every microsecond: every span
    stays in its own thread's request, under its own thread's parent."""
    threads, per = 8, 40
    barrier = threading.Barrier(threads)
    roots = {}

    def handler(k):
        barrier.wait(30)
        for j in range(per):
            with trace.request("viewer.request") as root:
                trace.note(path=f"/t{k}")
                with trace.span("render"):
                    with trace.span("render.binning"):
                        trace.count({"k": k, "j": j})
                with trace.span("encode.launch"):
                    pass
            roots[(k, j)] = root

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=handler, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert len(tracer.records) == threads * per * 4
    by_id = {r.id: r for r in tracer.records}
    assert len(by_id) == len(tracer.records)
    assert len({r.request for r in roots.values()}) == threads * per
    for (k, j), root in roots.items():
        assert root.args == {"path": f"/t{k}"} and root.counters == {"k": k, "j": j}
    for r in tracer.records:
        if r.parent is None:
            assert r.name == "viewer.request"
            continue
        parent = by_id[r.parent]
        assert (parent.request, parent.thread) == (r.request, r.thread)
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns


def test_tensor_counters_read_once_when_the_request_closes(tracer, monkeypatch):
    stacks = []
    real_stack = torch.stack
    monkeypatch.setattr(torch, "stack", lambda *a, **k: stacks.append(1) or real_stack(*a, **k))
    trace.count({"dropped.outside": torch.tensor(9)})  # no request: dropped
    patches = torch.tensor(3, dtype=torch.int32)
    with trace.request("viewer.request") as root:
        trace.count({"binning.patches": patches, "binning.rows": torch.tensor(5),
                     "binning.slots": 64})
        patches.add_(4)  # the counter is a reference, read at the close
        assert root.counters == {"binning.slots": 64} and not stacks
    assert stacks == [1]
    assert root.counters == {"binning.patches": 7, "binning.rows": 5, "binning.slots": 64}
    assert all(type(v) is int for v in root.counters.values())
    assert not root.pending


def _serve(renderer):
    started = []
    t = threading.Thread(target=serve, args=(renderer,),
                         kwargs=dict(port=0, on_ready=started.append), daemon=True)
    t.start()
    for _ in range(600):
        if started:
            return started[0], t
        time.sleep(0.05)
    raise RuntimeError("the viewer did not start")


def _closed_requests(tracer, n):
    """The root records of n requests, once their handlers have closed them
    (the client has the last byte before the handler returns)."""
    for _ in range(600):
        roots = tracer.named("viewer.request")
        if len(roots) >= n:
            return roots
        time.sleep(0.05)
    raise AssertionError(f"{len(tracer.named('viewer.request'))} of {n} requests closed")


@pytest.mark.parametrize("max_patches", [2**20, 4])
def test_served_render_spans_and_binning_counters(tracer, max_patches):
    renderer = SceneRenderer(_gaussians(), max_patches=max_patches, device="cpu")
    httpd, thread = _serve(renderer)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}{QUERY}",
                                    timeout=120) as resp:
            assert resp.status == 200
            body = resp.read()
        (root,) = _closed_requests(tracer, 1)
    finally:
        httpd.shutdown()
        thread.join(60)
    assert not thread.is_alive()
    mine = [r for r in tracer.records if r.request == root.request]
    children = {r.id: [c.name for c in mine if c.parent == r.id] for r in mine}
    (rend,) = [r for r in mine if r.name == "render"]
    assert sorted(children[root.id]) == ["encode.launch", "render"]
    assert set(children[rend.id]) == RENDER_CHILDREN
    assert children[rend.id].count("render.blend") == 2  # K4's stand-in, then frame_u8
    assert root.args == {"path": "/render", "lores": False, "size": "64x48", "status": 200,
                         "bytes": len(body)}
    # the counters equal a direct render's of the same view
    dev = renderer._device_params(markers=False, cloud=False, cloud_mode="rgb", mode="normal")
    _, aux = render(*dev, renderer.camera(**VIEW), backend=renderer.backend,
                    max_patches=max_patches, sh_degree=renderer.sh_degree, need_grads=False,
                    device="cpu")
    b = aux["binning"]
    assert set(root.counters) == set(BINNING) | set(BLEND)
    # the plain blend walks each of the view's 4 x 3 tiles as one item
    assert [root.counters[k] for k in BLEND] == [12, 0, 0]
    assert root.counters["binning.patches"] == int(aux["n_patches"]) > 0
    assert root.counters["binning.slots"] == max_patches
    assert root.counters["binning.kernel"] == 0  # CPU tensors take the slot path
    assert root.counters["binning.rows"] == int(b["total_rows"])
    assert root.counters["binning.rows_dropped"] == int(b["rows_dropped"])
    dropped = root.counters["binning.dropped"]
    assert dropped == int(b["n_dropped"])
    # a budget below the view's need drops the rest
    assert dropped == max(0, root.counters["binning.patches"] - max_patches)
    assert (dropped > 0) == (max_patches == 4)


def test_trace_flag_writes_chrome_events(tmp_path):
    path = tmp_path / "trace.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "easygaussiansplatting_tpu_torch.gaussian_viewer", "--serve",
         "--device", "cpu", "--port", "0", "--max-patches", "4", "--trace", str(path)],
        stdout=subprocess.PIPE, text=True)
    try:
        port = re.search(r":(\d+)/", proc.stdout.readline()).group(1)
        for q in (QUERY, "/info", QUERY + "&lores=1"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{q}", timeout=120) as resp:
                assert resp.status == 200
                resp.read()
        time.sleep(1.0)  # the last handler closes its request after the client's last byte
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    m = re.search(r"trace: 3 requests served, (\d+) of 2 renders dropped splats \(the most "
                  r"needed (\d+) tile rows and (\d+) patches, of 4 slots each\)", out)
    assert m and int(m.group(1)) >= 1 and max(int(m.group(2)), int(m.group(3))) > 4, out
    events = json.loads(path.read_text())["traceEvents"]
    assert {e["ph"] for e in events} == {"X"}
    assert all({"name", "ts", "dur", "pid", "tid", "args"} <= set(e) for e in events)
    assert all(e["dur"] >= 0 and "request" in e["args"] for e in events)
    roots = [e for e in events if e["name"] == "viewer.request"]
    assert [e["args"]["path"] for e in roots] == ["/render", "/info", "/render"]
    assert roots[0]["args"]["binning.slots"] == 4 and roots[0]["args"]["binning.dropped"] > 0
    assert {e["name"] for e in events} == {"viewer.request", "render", "encode.launch",
                                           *RENDER_CHILDREN}


@pytest.mark.cuda
def test_encode_wait_span_on_the_card(tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K11 is compiled with nvcc on the card")
    rgb = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8))
    with trace.request("viewer.request") as root:
        body = encode_jpeg(rgb.cuda())
    assert body == encode_jpeg(rgb)
    names = [r.name for r in tracer.records if r.parent == root.id]
    assert names == ["encode.launch", "encode.wait"]
