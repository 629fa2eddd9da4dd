"""The harness on the CPU: discovery of configurations, traffic mixes and
metrics by name, the metrics' arithmetic, a set's spreads and its summary,
the window's stretches, the frozen counting pinned to its
outputs, what the harness and the reference import, a run without a card,
and a cell defined by files alone."""

import json
import math
import subprocess
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

from benchmark import counting, harness, sets, stats
from benchmark.drivers import http_viewer

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_spec(ROOT)


def metric_names():
    return sorted(p.stem for p in (ROOT / "benchmark" / "metrics").glob("*.py"))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = harness.cell_entry(SPEC, cell)
    wl = harness.load_data("workloads", cell)
    cfg = harness.load_data("configs", entry["config"])
    assert wl["config"] == entry["config"] == cfg["name"]
    assert harness.load_driver(wl["driver"]).run
    assert {"setup_s"} < {m["name"] for m in harness.end_to_end_of(SPEC, cell)}
    assert harness.per_layer_of(SPEC, cell)
    for key in ("reduced", "assumed", "source"):
        assert key in cfg
    assert set(harness.load_data("workloads", cell)["limits"]) <= {
        "loss_gap", "grad1_gap", "change3_gap", "eval_psnr_gap_db", "coef_mismatch",
        "mcu_mismatch"}


@pytest.mark.parametrize("name", metric_names())
def test_metric_reader_found_by_name(name):
    mod = harness.load_reader(name)
    entry = next((m for m in SPEC["end_to_end"] + SPEC["per_layer"] if m["name"] == name), None)
    if entry is not None:
        assert mod.MOVES == entry.get("moves", name)
        if "layer" in entry:
            assert mod.LAYER == entry["layer"]
    # a reader that finds nothing to read returns nothing
    empty = harness.Run(cell="x", seed=0, seconds=1, trace=True, t_proc=0.0, config={},
                        workload={})
    assert mod.read(empty) is None


def test_config_files_match_spec():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg)


def test_metric_selection_by_cell():
    spec = {"end_to_end": [{"name": "setup_s"}, {"name": "a", "workloads": ["c1"]},
                           {"name": "b", "workloads": ["c2"]}],
            "per_layer": [{"name": "x", "moves": "a"}, {"name": "y", "moves": "b"},
                          {"name": "z", "moves": "b", "workloads": ["c1"]}]}
    assert [m["name"] for m in harness.end_to_end_of(spec, "c1")] == ["setup_s", "a"]
    assert [m["name"] for m in harness.per_layer_of(spec, "c1")] == ["x", "z"]
    assert [m["name"] for m in harness.per_layer_of(spec, "c2")] == ["y"]


def test_p95_is_over_every_request():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    # one slow request in twenty moves the p95, as it must
    assert stats.percentile([10.0] * 19 + [100.0], 95) > stats.percentile([10.0] * 20, 95)


def test_psnr_crossing_is_interpolated():
    pts = [(0.0, 10.0), (1.0, 20.0), (2.0, 24.0), (3.0, 26.0)]
    assert stats.crossing_time(pts, 25.0, 30.0) == pytest.approx(2.5)
    assert stats.crossing_time(pts, 20.0, 30.0) == pytest.approx(1.0)
    assert stats.crossing_time(pts, 27.0, 30.0) == 30.0  # never reached: the window
    assert stats.crossing_time([(0.5, 26.0)], 25.0, 30.0) == 0.5


def test_rate_is_over_the_whole_window():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_leaves_out_the_farthest_run():
    # range over the median, leaving out the run farthest from the median
    assert stats.spread([100.0, 101.0, 99.0, 150.0]) == pytest.approx(2.0 / 100.5)
    assert stats.spread([50.0, 100.0, 101.0, 99.0]) == pytest.approx(2.0 / 99.5)
    assert stats.spread([10.0, 10.0, 10.0]) == 0.0
    assert stats.spread([9.0, 11.0]) == pytest.approx(0.2)  # two runs: nothing left out
    # two far runs are not both left out
    assert stats.spread([50.0, 100.0, 100.0, 150.0, 100.0]) == pytest.approx(0.5)


def test_quartile_spread_is_pythons():
    values = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
    q1, q3 = 2.25, 6.75  # statistics.quantiles' default (exclusive) method: (n + 1) p
    assert stats.quartile_spread(values) == pytest.approx((q3 - q1) / 4.5)
    assert stats.quartile_spread([5.0] * 6) == 0.0


def test_window_stretches():
    # 10 requests a second for 12 s, then one slow request in the last stretch
    reqs = [{"t0": 0.1 * i, "t1": 0.1 * i + 0.05} for i in range(119)]
    reqs.append({"t0": 11.9, "t1": 11.99})
    st = http_viewer.window_stretches(reqs, 0.0, 12.0)
    assert st["seconds"] == 5.0
    assert st["frames_per_s"] == pytest.approx([10.0, 10.0, 10.0])  # the last 2 s hold 20
    assert st["frame_ms_p95"][:2] == pytest.approx([50.0, 50.0])
    assert st["frame_ms_p95"][2] > 50.0
    assert sum(f * s for f, s in zip(st["frames_per_s"], [5, 5, 2])) == pytest.approx(len(reqs))


def test_sets_keep_a_root_named_twice_apart():
    def rec(side, value):
        return {"side": side, "cell": "c", "set": 0,
                "line": {"correct": True, "metrics": {"m": {"value": value}}}}

    recs = [rec("0:/a", 10.0), rec("1:/b", 99.0), rec("2:/a", 20.0),
            rec("0:/a", 12.0), rec("1:/b", 98.0), rec("2:/a", 22.0)]
    got = sets.summary(recs)
    assert sorted(got) == ["0:/a|c|0", "1:/b|c|0", "2:/a|c|0"]
    assert got["0:/a|c|0"]["m"]["median"] == 11.0
    assert got["2:/a|c|0"]["m"]["median"] == 21.0
    assert got["2:/a|c|0"]["runs"] == 2 and got["2:/a|c|0"]["correct"] == 2


def test_sets_summarise_the_host_window():
    recs = [{"side": "0:/a", "cell": "c", "set": 0, "host_window": {"frames_per_s": v},
             "line": {"correct": True, "metrics": {"m": {"value": 1.0}}}}
            for v in (100.0, 120.0, 110.0)]
    got = sets.summary(recs)["0:/a|c|0"]
    assert got["host.frames_per_s"]["median"] == 110.0
    assert got["m"]["median"] == 1.0 and got["runs"] == 3


class _Event:
    def __init__(self, name, start_ns, duration_ns):
        self._name, self._start, self._duration = name, start_ns, duration_ns

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration


class _Profile:
    """Stands in for torch.profiler.profile: keeps the events of the
    renders made while it is on."""

    on = None

    def __init__(self, activities):
        self.events = []
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: list(self.events)))

    def start(self):
        _Profile.on = self

    def stop(self):
        _Profile.on = None


def _clock_program():
    wrappers = [types.SimpleNamespace(launches=0) for _ in range(3)]
    prog = types.SimpleNamespace(preprocess=types.SimpleNamespace(preprocess_fwd=wrappers[0]),
                                 rasterize=types.SimpleNamespace(rasterize_fwd=wrappers[1]),
                                 jpeg=types.SimpleNamespace(encode_jpeg=wrappers[2]))
    lose = {}  # render -> the kernel whose record the profiler drops
    count = [0]

    class Renderer:
        def render_device(self, **view):
            count[0] += 1
            t = 1000 * count[0]
            for w in wrappers:
                w.launches += 1
            if _Profile.on is not None:
                ev = [_Event("void preprocess_fwd_kernel<3>(float const*)", t, 100),
                      _Event("rasterize_fwd_kernel", t + 50, 200),
                      _Event("elementwise_kernel", t + 600, 10)]
                ev += [_Event(f"jpeg_{k}_kernel", t + 300 + 10 * i, 10)
                       for i, k in enumerate(("blocks", "lengths", "pack", "stuff"))]
                _Profile.on.events += [e for e in ev if lose.get(count[0]) != e.name()]

    return prog, Renderer, lose


@pytest.mark.parametrize("dropped", [0, 1, 2])
def test_device_clock_chunks_every_window_request(monkeypatch, dropped):
    """Set-up's renders are left out; chunks of 3 requests open before the
    window's 1st, 4th and 7th; each request is busy 250 + 40 + 10 ns; a
    chunk one record short of its launches counts, one two short is left
    out."""
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    prog, base, lose = _clock_program()
    # K1's record of the window's 4th request, then K4's of its 5th: both in its second chunk
    lose.update([(7, "void preprocess_fwd_kernel<3>(float const*)"),
                 (8, "rasterize_fwd_kernel")][:dropped])
    clock = http_viewer.DeviceClock(prog, chunk=3)
    r = clock.renderer_class(base)()
    clock.warm(lambda: [r.render_device() for _ in range(2)])
    clock.first = 4  # two set-up renders and one warm-up request before the window

    def client():
        for _ in range(8):
            r.render_device()

    t = threading.Thread(target=client)
    t.start()
    clock.serve(t.is_alive)
    t.join()
    got = clock.reduce()
    assert got["chunks"] == 3
    if dropped == 2:
        assert got["requests"] == 4 and got["lost"] == [{"K1": [2, 3], "K4": [2, 3],
                                                         "K11": [3, 3]}]
        assert got["busy_s"] == pytest.approx(4 * 300e-9)
    else:
        assert got["requests"] == 7 and got["lost"] == [] and got["one_short"] == dropped
        # a request whose K1 went unrecorded is busy from its K4's start
        assert got["busy_s"] == pytest.approx(7 * 300e-9 - dropped * 50e-9)
    run = harness.Run(cell="x", seed=0, seconds=1, trace=False, t_proc=0.0, config={},
                      workload={}, data={"device_clock": got})
    assert harness.load_reader("frame_device_ms").read(run) == pytest.approx(
        1e3 * got["busy_s"] / got["requests"])


def test_bound_pinned():
    b = counting.bound(3.35e9, 0, 0, 1980.0, 132)
    assert b == {"bound_ms": pytest.approx(1.0), "bound_by": "bytes"}
    b = counting.bound(0, 67e9, 0, 1980.0, 132)
    assert b == {"bound_ms": pytest.approx(1.0), "bound_by": "operations"}
    b = counting.bound(0, 0, 16 * 132 * 1980e6 * 1e-3, 1980.0, 132)
    assert b["bound_ms"] == pytest.approx(1.0)
    k1 = counting.k1_bound(150016, 3, 1980.0, 132)
    assert k1["bound_ms"] == pytest.approx(150016 * 4 * (3 + 48 + 1 + 3 + 4 + 12) / 3.35e9)


def test_work_arithmetic_pinned():
    work = {"evaluated": 1000, "passed": 600, "live": 400, "unclamped": 390, "moments": 380,
            "warp_live": 50, "entry_tile": 20, "warp_iters": 40}
    assert counting.k4_ops(work) == 1000 * 8 + 600 * 3 + 400 * 6 == 12200
    assert counting.k5_ops(work) == (1000 * 8 + 600 * 3 + 400 * 14 + 390 * 3 + 380 * 8 + 50 * 12
                                     + 20 * 21) == 20630
    assert counting.k4_bytes(100, 10, 50, 64) == 100 * 4 + 10 * 8 + 50 * 36 + 64 * 20
    assert counting.k5_bytes(100, 10, 50, 64, 128) == counting.k4_bytes(100, 10, 50, 64) + 36 * 128
    assert counting.loss_ops(100) == 3 * (100 * 44 * 8 + 100 * 70)
    assert counting.adam_ops(10) == 10 * 59 * 10


def test_jpeg_counts_pinned():
    coef = torch.zeros((1, 6, 64), dtype=torch.int16)
    assert counting.jpeg_tokens(coef) == 6 + 6  # a DC and an EOB a block
    coef[0, 0, 1] = 3
    coef[0, 0, 40] = -1  # 38 zeros before it: two ZRLs
    coef[0, 1, 63] = 2  # 62 zeros before it (three ZRLs), and the block has no EOB
    # DCs 6, nonzero ACs 3, ZRLs 2 + 3, EOBs 5
    assert counting.jpeg_tokens(coef) == 6 + 3 + 5 + 5
    b = counting.jpeg_bound(16, 16, coef, 100, 1980.0, 132)
    ops = (21 * 256 + 10 * 64 + (4 + 2) * (8 * 58 + 8 * 60 + 64 * 7) + 6 * 64
           + 18 * counting.jpeg_tokens(coef) + 2 * 100)
    assert b["bound_ms"] == pytest.approx(max(ops / (67e12 / 2), (3 * 256 + 100) / 3.35e12) * 1e3)


def test_blend_work_pinned():
    """One 16x16 tile, two entries, every pixel walking both: the counts
    against a pixel-by-pixel count of the same rules."""
    table = torch.zeros((2, counting.TABLE_COLS))
    table[0, 0:6] = torch.tensor([7.5, 7.5, 0.05, 0.0, 0.05, 0.99])
    table[1, 0:6] = torch.tensor([3.0, 3.0, 0.2, 0.01, 0.2, 0.5])
    patch_gsid = torch.tensor([0, 1], dtype=torch.int32)
    start, cnt = torch.tensor([0], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    walk = torch.full((16, 16), 2, dtype=torch.int64)
    work = counting.blend_work(table, patch_gsid, start, cnt, walk, 16, 16)
    want = dict.fromkeys(("passed", "live", "unclamped", "moments"), 0)
    warp_live = set()
    for g in range(2):
        ux, uy, a, b, c, alpha = (float(v) for v in table[g, 0:6])
        for py in range(16):
            for px in range(16):
                dx, dy = ux - px, uy - py
                maha = a * dx * dx + c * dy * dy + 2 * b * dx * dy
                ap = min(alpha * math.exp(-0.5 * max(maha, 0.0)), counting.ALPHA_CLAMP)
                want["passed"] += ap >= counting.ALPHA_SKIP * 2 ** -counting.CUTOFF_MARGIN
                live = ap >= counting.ALPHA_SKIP
                want["live"] += live
                want["unclamped"] += live and ap < counting.ALPHA_CLAMP
                want["moments"] += live and ap < counting.ALPHA_CLAMP and maha > 0
                if live:
                    warp_live.add((g, py // 8))
    assert work == {"evaluated": 512, **want, "warp_live": len(warp_live), "entry_tile": 2,
                    "warp_iters": 4}
    assert 0 < want["moments"] < want["live"] < 512


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=ROOT, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_drivers_load_no_jax():
    mods = _loaded("import benchmark.harness, benchmark.drivers.train, "
                   "benchmark.drivers.http_viewer, benchmark.drivers.client, benchmark.control, "
                   "benchmark.blend, benchmark.trace\n"
                   "from benchmark.drivers import train, http_viewer\n"
                   "train._Program(); http_viewer._Program()")
    assert harness.forbidden_modules(mods) == []
    assert "easygaussiansplatting_tpu_torch" in mods  # the program itself is loaded
    assert harness.forbidden_modules(["easygaussiansplatting_tpu_torch.ops", "jaxfoo"]) == []
    assert harness.forbidden_modules(["jax.numpy", "easygaussiansplatting_tpu.ops"]) == [
        "easygaussiansplatting_tpu.ops", "jax.numpy"]


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import benchmark.reference.render, benchmark.reference.train, "
                   "benchmark.reference.jpeg, benchmark.reference.jpeg_decode, "
                   "benchmark.scene, benchmark.counting, benchmark.stats")
    assert not [m for m in mods if m.split(".")[0].startswith("easygaussiansplatting")]
    assert harness.forbidden_modules(mods) == []


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def tiny_cell(tmp_path, kind):
    """A cell defined only by files: a BENCHMARK.json naming it, its
    configuration and traffic files; the metrics are the benchmark's."""
    bench = tmp_path / "bench"
    (bench / "configs").mkdir(parents=True)
    (bench / "workloads").mkdir()
    (bench / "metrics").symlink_to(ROOT / "benchmark" / "metrics")
    spec = json.loads(json.dumps(SPEC))
    if kind == "train":
        base, cell = "truck_train", "tiny_train.from_init"
        cfg = harness.load_data("configs", base)
        cfg.update(name="tiny_train", views=6, width=48, height=32, gt_gaussians=300,
                   capacity=512, max_patches=2**13, log_scale_mean=-2.5)
        wl = harness.load_data("workloads", "truck_train.from_init")
        wl.update(config="tiny_train", warmup_steps=1, target_psnr=12.0)
    else:
        base, cell = "truck_view", f"tiny_view.{kind}"
        cfg = harness.load_data("configs", base)
        cfg.update(name="tiny_view", gaussians=2000, width=80, height=48, max_patches=2**14,
                   log_scale_mean=-2.8)
        wl = harness.load_data("workloads", f"truck_view.{kind}")
        wl.update(config="tiny_view", sample=4)
    spec["workloads"] = [{"name": cell, "config": cfg["name"], "traffic": kind, "chips": 1,
                          "why": "a cell of files alone"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    if kind == "train":
        # the training cell's metrics, each a reader file of the benchmark
        spec["end_to_end"] = [m for m in spec["end_to_end"] if m["name"] == "setup_s"] + [
            {"name": n, "unit": u, "better": b, "bound": 0.25, "source": "host_clock",
             "workloads": [cell]}
            for n, u, b in (("time_to_psnr25_s", "s", "lower"),
                            ("train_views_per_s", "views/s", "higher"))]
        spec["per_layer"] = [
            {"name": n, "unit": u, "better": "lower", "source": "device_trace", "layer": layer,
             "moves": "train_views_per_s", "workloads": [cell]}
            for n, u, layer in (("train.densify_ms", "ms", "epoch driver"),
                                ("train.step_device_ms", "ms", "train step"),
                                ("train.step_mfu", "%", "train step"),
                                ("train.rasterize_bwd_roofline", "%", "blend kernels (K4, K5)"),
                                ("train.device_idle_share", "%", "device"))]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    return cell, tmp_path, bench


@pytest.mark.parametrize("kind", ["train", "short_drags", "drag_preview"])
def test_a_cell_of_files_alone_runs(tmp_path, kind):
    cell, root, bench = tiny_cell(tmp_path, kind)
    run, line = harness.run_cell(cell, 2**31 + 5, 2.0, False, 0.0, root=root, bench=bench,
                                 device="cpu")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = set(line["metrics"])
    # on the CPU no metric of the device is read
    want = {m["name"] for m in harness.end_to_end_of(json.loads(
        (root / "BENCHMARK.json").read_text()), cell) if m["source"] == "host_clock"}
    assert names == want
    assert all(math.isfinite(v["value"]) and v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"
