"""Driver ``http_viewer``: the program's web viewer (``viewer/server.py``'s
``serve`` on a ``SceneRenderer``, built as ``gaussian_viewer --serve`` builds
it) answering one closed-loop client (``client.py``, a child process) for
the whole window.

Set-up builds the kernels, draws the served scene on the device from the
configuration's ``scene_seed`` (``benchmark/scene.py::view_scene``), hands
it to the renderer, warms each frame size of the traffic, starts the server
on a free port and the client, which warms the HTTP path before its window.
The client's window is the run's window. Where the process may use two
cores or more, the client runs alone on the last of them and every thread
of the server's process on the others, so that neither takes the other's
core. With ``--trace 0`` the profiler traces the device's activity alone
over every request of the window, in chunks (``DeviceClock``), for its
busy seconds. With ``--trace 1`` the renderer is a subclass
that times ``render_device`` (ending in a synchronise) and the encode, and
one stretch of requests is profiled, with K4's inputs and the encoded
frames kept for the readers.

After the window a sample of the responses, drawn from the seed, is judged
against the reference: the frame rendered by ``benchmark/reference`` from
the same scene and camera, quantised to 8 bits and taken through the frozen
encoder's DCT and quantiser, against the coefficients the served JPEG holds:
the share that differ over the frame, and the largest share in any one MCU
(16x16 pixels, 384 coefficients), which a fault confined to a few tiles
moves.
"""

import base64
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import blend
from benchmark import scene as bscene
from benchmark import stats
from benchmark.reference import jpeg as ref_jpeg
from benchmark.reference import jpeg_decode
from benchmark.reference import render as ref_render
from benchmark.trace import Keeper, Profile, short_name, union

CLIENT = Path(__file__).resolve().parent / "client.py"
STRETCH_S = 5.0  # the window's request rate and p95 are also reported a stretch of this length
# requests a profiled chunk of an untraced window: some 80,000 device records,
# well inside the profiler's buffers
CHUNK_REQUESTS = 2000


class _Program:
    def __init__(self):
        from easygaussiansplatting_tpu_torch.ops.kernels import _build, jpeg, preprocess, rasterize
        from easygaussiansplatting_tpu_torch.viewer import server

        self.build, self.jpeg, self.preprocess, self.rasterize = _build, jpeg, preprocess, rasterize
        self.server = server


class Tracer:
    """The traced run's instrumentation: spans around ``render_device`` and
    the encode, and the profiled stretch of ``count`` requests, from request
    ``first``; a stretch whose records do not match the launches is taken
    again ``every`` requests later, up to ``tries`` stretches. A request
    holds the gate from its render to the end of its encode; the profiler
    is started and stopped by the run's main thread between two requests,
    while the request that would come next waits."""

    def __init__(self, run, prog, first, count, every, tries):
        self.run, self.p, self.count = run, prog, count
        starts = [first + k * every for k in range(tries)]
        self.triggers = set(starts) | {s + count for s in starts}
        self.n = 0
        self.start_n = None
        self.gate = threading.Lock()
        self.want = threading.Event()
        self.resume = threading.Event()
        self.frames = []
        self.profile = None
        self.groups = kernel_groups(prog)

    def renderer_class(self):
        tracer = self

        class TimedRenderer(self.p.server.SceneRenderer):
            def render_device(self, **view):
                tracer.gate.acquire()
                tracer.n += 1
                if tracer.n in tracer.triggers:
                    tracer.want.set()
                    tracer.resume.wait()
                    tracer.resume.clear()
                t = time.perf_counter()
                out = super().render_device(**view)
                torch.cuda.synchronize()
                tracer.run.spans.add("render_device", t, time.perf_counter())
                return out

        return TimedRenderer

    def encode(self, fn):
        def timed(rgb, quality=90):
            try:
                t = time.perf_counter()
                body = fn(rgb, quality)
                self.run.spans.add("encode_jpeg", t, time.perf_counter())
                if self.profile is not None and (self.n - self.start_n) % blend.STRIDE == 0:
                    self.frames.append((rgb, body))
                return body
            finally:
                self.gate.release()

        return timed

    def serve_profile(self, alive):
        """Main thread: start and stop the profiled stretches at the
        triggers, while ``alive()``; a stretch the window cut short is
        stopped and left unread."""
        while True:
            while not self.want.wait(0.05):
                if not alive():
                    if self.profile is not None:
                        self._stop()
                        self.run.profile_lost = "the window ended inside the profiled requests"
                    return
            self.want.clear()
            if self.profile is None:
                self._orig = self.p.rasterize.rasterize_fwd
                self.kept = {"rasterize_fwd": Keeper(self._orig, blend.STRIDE)}
                self.p.rasterize.rasterize_fwd = self.kept["rasterize_fwd"]
                self.groups["K4"] = (self.groups["K4"][0], self._orig, 1)
                self.frames, self.start_n = [], self.n
                self.profile = Profile(self.groups, self.run.spans)
                self.profile.start()
            else:
                self._stop()
                result = self.profile.reduce()
                if result is not None:
                    self.run.profile, self.run.profile_lost = result, None
                    self.run.data["profile"] = {"requests": self.count, "kept": self.kept,
                                                "frames": self.frames}
                    self.triggers = set()
                else:
                    self.run.profile_lost = self.profile.lost
                self.profile = None
            self.resume.set()

    def _stop(self):
        self.profile.stop()
        self.p.rasterize.rasterize_fwd = self._orig


def kernel_groups(prog):
    """The port kernels whose device records are held against their
    wrappers' launch counters: label -> (device kernel names, wrapper,
    device kernels a launch)."""
    return {"K1": (("preprocess_fwd_kernel",), prog.preprocess.preprocess_fwd, 1),
            "K4": (("rasterize_fwd_kernel",), prog.rasterize.rasterize_fwd, 1),
            "K11": (("jpeg_blocks_kernel", "jpeg_lengths_kernel", "jpeg_pack_kernel",
                     "jpeg_stuff_kernel"), prog.jpeg.encode_jpeg, 4)}


class DeviceClock:
    """The untraced run's device clock: the device's busy seconds over
    every request of the window, from ``torch.profiler`` tracing device
    activity alone, in chunks of ``chunk`` requests so that its buffers never
    fill. A chunk opens before request ``first`` and every ``chunk``
    requests after it: that request waits while the run's main thread (a
    profiler is stopped by the thread that started it) synchronises, stops
    the open chunk and starts the next. The last chunk closes when the
    client has ended."""

    def __init__(self, prog, chunk=CHUNK_REQUESTS):
        self.groups = kernel_groups(prog)
        self.chunk = chunk
        self.first = None  # set once the set-up's renders are counted
        self.n = 0  # render_device calls, the set-up's among them
        self.rendered = 0  # of them, those that went on to render
        self.want, self.resume = threading.Event(), threading.Event()
        self.prof = None
        self.chunks = []  # (profile, requests, launches by kernel)
        self.stall_s = 0.0

    def renderer_class(self, base):
        clock = self

        class ClockedRenderer(base):
            def render_device(self, **view):
                clock.n += 1
                if clock.first is not None and clock.n >= clock.first and (
                        clock.n - clock.first) % clock.chunk == 0:
                    clock.want.set()
                    clock.resume.wait()
                    clock.resume.clear()
                clock.rendered += 1
                return super().render_device(**view)

        return ClockedRenderer

    def warm(self, work):
        """Run ``work`` under a chunk that is not kept: the profiler's
        first start readies CUPTI, which takes seconds."""
        self._start()
        work()
        self._stop()
        self.chunks = []

    def serve(self, alive):
        """Main thread: close and open the chunks while ``alive()``, then
        close the last."""
        while True:
            while not self.want.wait(0.05):
                if not alive():
                    if self.prof is not None:
                        self._stop()
                    return
            self.want.clear()
            t = time.perf_counter()
            if self.prof is not None:
                self._stop()
            self._start()
            self.stall_s += time.perf_counter() - t
            self.resume.set()

    def _start(self):
        torch.cuda.synchronize()
        self._from = (self.rendered, {k: w.launches for k, (_, w, _) in self.groups.items()})
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()

    def _stop(self):
        torch.cuda.synchronize()
        self.prof.stop()
        n0, l0 = self._from
        self.chunks.append((self.prof, self.rendered - n0,
                            {k: w.launches - l0[k] for k, (_, w, _) in self.groups.items()}))
        self.prof = None

    def reduce(self):
        """{"busy_s", "requests"} over the chunks whose records match the
        launches, with the count of chunks, those lost, those one record
        short, and the seconds the requests waited for the chunks' changes.
        A chunk may fall one record short of a kernel's launches: the
        first kernel after the profiler's start (K1, which opens a render)
        is at times not recorded, some 15 us of a chunk's seconds."""
        cuda = torch.autograd.DeviceType.CUDA
        names = {}
        busy_s, requests, lost, short = 0.0, 0, [], 0
        chunks, self.chunks = self.chunks, []
        for prof, n, launched in chunks:
            dev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
            records = dict.fromkeys(self.groups, 0)
            for e in dev:
                name = names.setdefault(e.name(), short_name(e.name()))
                for k, (kernels, _, _) in self.groups.items():
                    records[k] += name in kernels
            records = {k: records[k] // per for k, (_, _, per) in self.groups.items()}
            missing = sum(launched[k] - records[k] for k in records)
            if missing > 1 or any(records[k] > launched[k] for k in records):
                lost.append({k: [records[k], launched[k]] for k in records})
                continue
            short += missing
            iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev)
            busy_s += 1e-9 * sum(e - s for s, e in union(iv))
            requests += n
        return {"busy_s": busy_s, "requests": requests, "chunks": len(chunks), "lost": lost,
                "one_short": short, "stall_s": self.stall_s}


def warm_up(prog, renderer, sizes, view, quality):
    for lores in sizes:
        for _ in range(2):
            prog.server.encode_jpeg(renderer.render_device(**view, lores=lores), quality=quality)
    if renderer.device.type == "cuda":
        torch.cuda.synchronize()


def run(run):
    phases = run.data.setdefault("setup_phases", {})
    p = _Program()
    phases["imports"] = time.perf_counter() - run.t_proc
    dev = torch.device(run.device)
    cfg, wl = run.config, run.workload
    if dev.type == "cuda":
        p.build.build()
        p.build.library()
        phases["library"] = time.perf_counter() - run.t_proc
        torch.cuda.reset_peak_memory_stats()
    tracer = None
    if run.trace and dev.type == "cuda":
        prof = wl["profile"]
        tracer = Tracer(run, p, prof["first_request"], prof["requests"], prof["every"],
                        prof["tries"])
    cls = tracer.renderer_class() if tracer else p.server.SceneRenderer
    clock = DeviceClock(p) if not run.trace and dev.type == "cuda" else None
    if clock:
        cls = clock.renderer_class(cls)
    phases["build"] = time.perf_counter() - run.t_proc
    scene = bscene.view_scene(cfg, dev)
    host = {k: v.cpu().numpy() for k, v in scene.items()}
    del scene
    phases["scene"] = time.perf_counter() - run.t_proc
    renderer = cls(host, max_patches=cfg["max_patches"], device=dev)
    del host
    phases["renderer"] = time.perf_counter() - run.t_proc
    view = {"width": cfg["width"], "height": cfg["height"], "fov_f": cfg["fov_f"]}
    encode = p.server.encode_jpeg
    if tracer:
        p.server.encode_jpeg = tracer.encode(encode)
    sizes = sorted({r["lores"] for r in wl["pattern"]})
    # the spans of the warm-up renders here and of the client's warm-up
    # requests come before the window's
    run.data["spans_skip"] = 2 * len(sizes) + wl["warmup_requests"]
    try:
        if clock:  # the profiler's first start, which is slow, in the set-up
            clock.warm(lambda: warm_up(p, renderer, sizes, view, cfg["jpeg_quality"]))
            clock.first = run.data["spans_skip"] + 1
        else:
            warm_up(p, renderer, sizes, view, cfg["jpeg_quality"])
        phases["warm_up"] = time.perf_counter() - run.t_proc
        out = serve_window(run, p, renderer, tracer, clock)
    finally:
        p.server.encode_jpeg = encode
    if clock:
        run.data["device_clock"] = clock.reduce()
    if tracer and run.profile is None and run.profile_lost is None:
        run.profile_lost = "the window ended before the profiled requests"
    reqs = out["requests"]
    run.setup_s = out["t_start"] - run.t_proc
    phases["client"] = run.setup_s
    run.window_s = out["t_end"] - out["t_start"]
    run.attempted = len(reqs)
    run.failed = sum(not r["ok"] for r in reqs)
    run.data.update({"latencies_ms": [1e3 * (r["t1"] - r["t0"]) for r in reqs],
                     "requests": reqs, "warmup": out["warmup"], "completed": len(reqs)})
    run.data["window_stretches"] = window_stretches(reqs, out["t_start"], out["t_end"])
    run.data["host_window"] = {"frames_per_s": stats.rate(len(reqs), run.window_s),
                               "frame_ms_p95": stats.percentile(run.data["latencies_ms"], 95)}
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()
    del renderer
    compare(run, {int(k): base64.b64decode(v) for k, v in out["sample"].items()}, reqs, dev)


def window_stretches(reqs, t_start, t_end, every=STRETCH_S):
    """The window's request rate and p95 latency (ms) in each stretch of
    ``every`` seconds, a request counted in the stretch it completed in;
    the last stretch is what remains of the window."""
    n = max(1, math.ceil((t_end - t_start) / every))
    lat = [[] for _ in range(n)]
    for r in reqs:
        lat[min(int((r["t1"] - t_start) // every), n - 1)].append(1e3 * (r["t1"] - r["t0"]))
    seconds = [every] * (n - 1) + [t_end - t_start - every * (n - 1)]
    return {"seconds": every, "frames_per_s": [len(v) / s for v, s in zip(lat, seconds)],
            "frame_ms_p95": [stats.percentile(v, 95) if v else None for v in lat]}


def pin_process(cores):
    """Every thread of this process onto ``cores`` (a thread made later
    takes its maker's)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:  # the thread has ended
            pass


class GcTimes:
    """The garbage collector's passes in this process while it is on: their
    count and seconds by generation."""

    def __init__(self):
        self.count, self.seconds, self._t = [0, 0, 0], [0.0, 0.0, 0.0], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def serve_window(run, prog, renderer, tracer, clock=None):
    """Serve the client's window; returns the client's JSON."""
    # The card's host shows no SMT topology and does not enforce affinity,
    # so no siblings are read: the client takes the last CPU.
    cores = sorted(os.sched_getaffinity(0))
    client_core = cores[-1] if len(cores) > 1 else None
    if client_core is not None:
        pin_process(set(cores[:-1]))
    ready = threading.Event()
    box = {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    thread = threading.Thread(target=prog.server.serve, args=(renderer,),
                              kwargs={"port": 0, "on_ready": on_ready}, daemon=True)
    thread.start()
    if not ready.wait(60):
        raise RuntimeError("the viewer did not start")
    httpd = box["httpd"]
    wl, cfg = run.workload, run.config
    rng = np.random.default_rng(run.seed)
    args = {"host": "127.0.0.1", "port": httpd.server_address[1], "seconds": run.seconds,
            "warmup": wl["warmup_requests"], "pattern": wl["pattern"],
            "az0": float(rng.uniform(0.0, 2.0 * np.pi)), "az_step": wl["az_step"],
            "el_base": wl["elevation"]["base"], "el_amp": wl["elevation"]["amp"],
            "width": cfg["width"], "height": cfg["height"], "lores_div": cfg["lores_div"],
            "sample": wl["sample"], "seed": run.seed, "core": client_core}
    child = subprocess.Popen([sys.executable, str(CLIENT), json.dumps(args)],
                             stdout=subprocess.PIPE, env=dict(os.environ))
    # the client's answer is read while the main thread serves the profile:
    # a full pipe would stop the client before it exits
    out = {}
    reader = threading.Thread(target=lambda: out.update(stdout=child.stdout.read()), daemon=True)
    reader.start()
    try:
        with GcTimes() as gct:
            if tracer:
                tracer.serve_profile(lambda: reader.is_alive())
            elif clock:
                clock.serve(lambda: reader.is_alive())
            reader.join(run.seconds + 300)
        run.data["server_gc"] = {"count": gct.count, "seconds": gct.seconds}
        child.wait(60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        httpd.shutdown()
        thread.join(60)
    if child.returncode != 0 or "stdout" not in out:
        raise RuntimeError(f"the client exited with {child.returncode}")
    return json.loads(out["stdout"])


def reference_frame(params, req, cfg, dtype):
    """The reference's 8-bit frame [H, W, 3] of a request's view."""
    w, h = cfg["width"], cfg["height"]
    cam = bscene.orbit_camera(req["center"], req["r"], req["az"], req["el"], w, h,
                              cfg["fov_f"], cfg["lores_div"] if req["lores"] else 1)
    img = ref_render.render({k: v.to(dtype) for k, v in params.items()}, cam).float()
    return (torch.clamp(img, 0.0, 1.0).permute(1, 2, 0) * 255).to(torch.uint8).contiguous()


def mismatch(body, frame, quality):
    """(share of the frame's, largest share of one MCU's) quantised
    coefficients in which a served JPEG differs from the reference frame's;
    (1.0, 1.0) for a body that is not such a JPEG."""
    h, w, _ = frame.shape
    want = ref_jpeg.coefficients(frame, quality).cpu().numpy().astype(np.int64)
    try:
        got = jpeg_decode.coefficients(body, w, h, quality)
    except jpeg_decode.JpegError:
        return 1.0, 1.0
    differ = (got != want).reshape(len(want), -1)
    return float(differ.mean()), float(differ.mean(axis=1).max())


def compare(run, bodies, reqs, dev):
    """Judge the sampled responses; records each number beside its limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = run.config
    params = bscene.view_scene(cfg, dev)
    dtype = getattr(torch, cfg["precision"])
    shares = {j: mismatch(body, reference_frame(params, reqs[j], cfg, dtype), cfg["jpeg_quality"])
              for j, body in sorted(bodies.items())}
    limits = run.workload["limits"]
    run.check("failed", run.failed, 0)
    run.check("coef_mismatch", max((a for a, _ in shares.values()), default=1.0),
              limits["coef_mismatch"])
    run.check("mcu_mismatch", max((b for _, b in shares.values()), default=1.0),
              limits["mcu_mismatch"])
    run.data["compared"] = {"coef_mismatch": {j: a for j, (a, _) in shares.items()},
                            "mcu_mismatch": {j: b for j, (_, b) in shares.items()}}
