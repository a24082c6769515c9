"""The port's profiling and roofline utilities (utils/profiling.py,
utils/roofline.py), as tests/test_aux.py holds the JAX package's: the span
and counter recorder (on exactly while a profiler session is active, off at
no cost, nesting, self time, host syncs, the clock it shares with the
profiler's events), ``idle_by_span``, a trace written on the CPU with the
program's spans in it, the spans of the served view and the stacked step
and the benchmark's readers of them, no memory stats without a card; the
step report's keys, the K1/K2 bounds on PERF.md's pair counts, and
``chip_smoke.py``'s bounds taken from the module; on the card (``-m gpu``)
the host syncs of a served view and a span around K1's launch. Imports no
JAX."""

import importlib
import json
import math
import os
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke
from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.render import RenderConfig, render
from gaussian_transformer_tpu_torch.render import stream as stream_mod
from gaussian_transformer_tpu_torch.scene.cameras import Camera
from gaussian_transformer_tpu_torch.utils import profiling, roofline
from gaussian_transformer_tpu_torch.utils.profiling import (
    OUTSIDE,
    SYNC_WARNING,
    SYNCS,
    Span,
    count,
    device_memory_stats,
    idle_by_span,
    span,
    summary,
    trace,
)
from gaussian_transformer_tpu_torch.viewer.network_gui import image_to_bytes

ROOT = Path(__file__).resolve().parent.parent
COUNTS = {"n_gaussians": 1_200_000, "n_instances": 3_276_800, "i_pad": 3_014_656, "real_rows": 2_310_000,
          "n_tiles": 8160, "height": 1080, "width": 1920, "walked": 536_700_000, "contributing": 238_700_000}
STAGES = ("project", "bin", "gather", "fwd_kernel", "bwd_kernel", "loss_adam")
SERVE_SPANS = ("render", "render.project", "render.bin", "render.gather", "render.composite", "frame.bytes")


@pytest.fixture(autouse=True)
def clean_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name():
    return {s.name: s for s in profiling.RECORDER.spans}


def _scene(n, seed, device):
    rng = np.random.RandomState(seed)
    op = rng.uniform(0.05, 0.95, (n, 1))
    fields = {
        "xyz": rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        "features_dc": (0.3 * rng.randn(n, 1, 3)).astype(np.float32),
        "features_rest": (0.05 * rng.randn(n, 15, 3)).astype(np.float32),
        "scaling": rng.uniform(-4.0, -2.0, (n, 3)).astype(np.float32),
        "rotation": rng.randn(n, 4).astype(np.float32),
        "opacity": np.log(op / (1 - op)).astype(np.float32),
        "alive": np.ones(n, bool),
    }
    return scene_from_numpy(fields, 3, device)


def _camera(width, height, device):
    return Camera.create(0, np.eye(3), np.array([0.0, 0.0, 4.0]), math.radians(60.0),
                         math.radians(60.0 * height / width), None, None, "k", 0,
                         width=width, height=height, device=device)


def _serve(scene, cam):
    """One served view as the benchmark's serving cell serves it."""
    with torch.no_grad():
        out = render(cam, scene, RenderConfig(), bg_color=torch.zeros(3, device=scene.get_xyz.device))
        return out, image_to_bytes(out["render"])


def test_spans_nest_with_parent_root_and_self_time():
    with _cpu_profile():
        with span("step"):
            time.sleep(0.002)
            with span("a"):
                time.sleep(0.004)
                with span("a.inner"):
                    time.sleep(0.003)
            with span("b"):
                time.sleep(0.003)
        with span("step"):
            pass
    spans = profiling.RECORDER.spans
    assert [s.name for s in spans] == ["a.inner", "a", "b", "step", "step"]
    inner, a, b, step, step2 = spans
    assert step.parent is None and step.root == step.id
    assert a.parent == step.id and b.parent == step.id and inner.parent == a.id
    assert {a.root, b.root, inner.root} == {step.id} and step2.root == step2.id != step.id
    assert step.start_ns <= a.start_ns <= inner.start_ns <= inner.end_ns <= a.end_ns <= b.start_ns
    assert b.end_ns <= step.end_ns and len({s.thread for s in spans}) == 1
    rows = summary()["spans"]
    ms = lambda s: (s.end_ns - s.start_ns) * 1e-6  # noqa: E731
    assert rows["step"]["count"] == 2
    assert rows["step"]["total_ms"] == pytest.approx(ms(step) + ms(step2))
    assert rows["step"]["self_ms"] == pytest.approx(ms(step) - ms(a) - ms(b) + ms(step2))
    assert rows["a"]["self_ms"] == pytest.approx(ms(a) - ms(inner))
    assert rows["a.inner"]["self_ms"] == rows["a.inner"]["total_ms"] == pytest.approx(ms(inner))
    assert rows["step"]["self_ms"] >= 1.9 and rows["a"]["self_ms"] >= 3.9
    profiling.reset()
    assert summary() == {"spans": {}, "counters": {}}


class _Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(func)
        return func(*args, **(kwargs or {}))


def test_off_records_nothing_at_no_cost(monkeypatch):
    """No profiler session: one shared no-op object, and no clock read,
    record_function range, tensor op or CUDA call."""
    assert not torch.autograd._profiler_enabled()

    def boom(*a, **k):
        raise AssertionError("called while tracing is off")

    for owner, name in ((profiling.time, "time_ns"), (torch.profiler, "record_function"),
                        (torch.cuda, "get_sync_debug_mode"), (torch.cuda, "set_sync_debug_mode"),
                        (torch.cuda, "is_available")):
        monkeypatch.setattr(owner, name, boom)
    first = span("a")
    with _Calls() as calls:
        with span("a") as got:
            with span("b"):
                count("c", 5)
        assert got is None
    assert span("b") is first and calls.calls == []
    assert profiling.RECORDER.spans == [] and summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("how", ["context", "start_stop", "trace"])
def test_on_exactly_while_a_profiler_session_is_active(how, tmp_path):
    def inside():
        with span("x"):
            count("n", 2)

    inside()
    if how == "context":
        with _cpu_profile():
            inside()
    elif how == "start_stop":
        prof = _cpu_profile()
        prof.start()
        inside()
        prof.stop()
    else:
        with trace(str(tmp_path)):
            inside()
    inside()
    s = summary()
    assert s["spans"]["x"]["count"] == 1 and s["counters"] == {"n": 2}


def test_span_shares_the_profilers_clock():
    """A span around a record_function range encloses that range's kineto
    event, in ns: the span reads the clock of the profiler's events."""
    with _cpu_profile() as prof:
        with span("outer") as outer:
            with record_function("user_range"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "user_range"]
    assert len(events) == 1
    e = events[0]
    assert outer.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= outer.end_ns
    # The span's own range in the profiler lies inside it as well.
    own = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    assert len(own) == 1 and outer.start_ns - own[0].start_ns() < 1_000_000


def _span(name, sid, a, b):
    return Span(name, sid, None, sid, 0, a, b)


@pytest.mark.parametrize("case", ["nested", "outside", "no_gaps"])
def test_idle_by_span_splits_each_gap(case):
    if case == "nested":
        # Device busy [0, 10), [20, 30), [45, 50); host: root [5, 48), child [15, 25), grandchild [40, 47).
        dev = [(0, 10), (20, 30), (2, 4), (45, 50)]
        spans = [_span("root", 1, 5, 48), _span("child", 2, 15, 25), _span("leaf", 3, 40, 47)]
        want = {"root": 5 + 10, "child": 5, "leaf": 5}
    elif case == "outside":
        # Gaps [10, 20) and [30, 60): a span covers [12, 15) and [40, 70).
        dev = [(0, 10), (20, 30), (60, 61)]
        spans = [_span("a", 1, 12, 15), _span("b", 2, 40, 70)]
        want = {"a": 3, "b": 20, OUTSIDE: 7 + 10}
    else:
        dev = [(0, 10), (5, 20), (20, 30)]
        spans = [_span("a", 1, 0, 30)]
        want = {}
    got = idle_by_span(dev, spans)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k] * 1e-9)
    idle = sum(b[0] - a[1] for a, b in zip(profiling._merged(dev), profiling._merged(dev)[1:]))
    assert sum(got.values()) == pytest.approx(idle * 1e-9)
    assert list(got.values()) == sorted(got.values(), reverse=True)


def test_trace_produces_files(tmp_path):
    with trace(str(tmp_path)) as window:
        with span("matmul_span"):
            torch.ones(128, 128) @ torch.ones(128, 128)
    found = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert len(found) == 1 and found[0].endswith(".pt.trace.json")
    with open(tmp_path / found[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul_span" for e in events)
    assert any(e.key == "matmul_span" for e in window.prof.key_averages())


def test_trace_writes_the_program_spans_on_its_time_base(tmp_path):
    with trace(str(tmp_path)) as window:
        with span("outer"):
            with span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    with open(window.path) as f:
        doc = json.load(f)
    ours = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "program_span"}
    assert set(ours) == {"outer", "inner"} and [s.name for s in window.spans] == ["inner", "outer"]
    assert ours["inner"]["args"]["parent"] == ours["outer"]["args"]["id"]
    # Each span lies within its own record_function range in the same file
    # (opened just before the span's clock is read, closed just after).
    for name, e in ours.items():
        rf = [x for x in doc["traceEvents"] if x.get("name") == name and x.get("cat") == "user_annotation"]
        assert len(rf) == 1
        assert rf[0]["ts"] - 1e-3 <= e["ts"] <= rf[0]["ts"] + 1e3
        assert e["ts"] + e["dur"] <= rf[0]["ts"] + rf[0]["dur"] + 1e-3
    assert window.device == [] and window.idle_by_span() == {}


def test_host_syncs_go_to_the_innermost_span(monkeypatch):
    """Each synchronisation's warning is counted where it happens, on the
    span's thread or, from a thread with no span open (autograd's), on the
    span opened last; the warning filters are restored after the root."""
    filters = list(warnings.filters)
    sync = lambda: warnings.warn(SYNC_WARNING + " (triggered here)", UserWarning)  # noqa: E731
    with _cpu_profile():
        with span("root"):
            sync()
            with span("child"):
                sync()
                sync()
                t = threading.Thread(target=sync)
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
            with pytest.warns(DeprecationWarning, match="unrelated"):
                warnings.warn("unrelated", DeprecationWarning)
        assert warnings.filters == filters
    s = summary()
    assert s["spans"]["root"]["syncs"] == 1 and s["spans"]["child"]["syncs"] == 3
    assert s["counters"] == {SYNCS: 4}


def test_served_view_spans_and_counters():
    scene, cam = _scene(1500, 0, "cpu"), _camera(96, 64, "cpu")
    _serve(scene, cam)
    assert profiling.RECORDER.spans == []
    with _cpu_profile():
        out, _ = _serve(scene, cam)
    by = _by_name()
    assert set(by) == set(SERVE_SPANS)
    root = by["render"]
    for name in ("render.project", "render.bin", "render.gather", "render.composite"):
        assert by[name].parent == root.id and by[name].root == root.id
    assert by["frame.bytes"].parent is None
    order = [by[n] for n in ("render.project", "render.bin", "render.gather", "render.composite")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    c = summary()["counters"]
    assert c["render.slots_sorted"] == max(8192, 16 * 1500)
    stream_gauss, _ = stream_mod.used_stream(_prepared(scene, cam).binned)
    assert c["render.rows_used"] == stream_gauss.shape[0] >= int(out["n_padded"])


def _prepared(scene, cam):
    from gaussian_transformer_tpu_torch.render import prepare_stream

    with torch.no_grad():
        return prepare_stream(cam, scene, RenderConfig())


def _tiny_cell(name):
    from perfbench import core

    conftest = core.load_module(ROOT / "perfbench" / "tests" / "conftest.py", "perfbench_tests_conftest")
    return conftest.tiny_cell(name)


NEW_METRICS = {
    "splat_serve": ["project_host_ms.serve", "bin_host_ms.serve", "gather_host_ms.serve",
                    "composite_host_ms.serve", "frame_bytes_host_ms.serve", "host_syncs_per_view.serve",
                    "sort_slots_per_row.serve"],
    "stacked_train": ["batch_build_host_ms.stacked", "batch_upload_host_ms.stacked", "encode_host_ms.stacked",
                      "decode_host_ms.stacked", "loss_host_ms.stacked", "backward_host_ms.stacked",
                      "optimizer_host_ms.stacked", "host_syncs_per_step.stacked"],
}


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_traced_cell_reads_every_span_metric(name):
    """A traced run of each cell at a tiny size on the CPU: every reader of
    the program's spans and counters finds its number, and the stages and
    the root's self time cover the slice's units."""
    from perfbench import core

    cell = _tiny_cell(name)
    driver = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, 3_000_000_019, 0.5, True, torch.device("cpu"), time.perf_counter())
    r = out["readings"]
    got = core.Cell(core.load_benchmark(), name).read_per_layer(r)
    assert set(NEW_METRICS[name]) <= set(got)
    s = summary()["spans"]
    root = "render" if name == "splat_serve" else "stacked.step"
    assert s[root]["count"] == r["trace_units"]
    roots = {x.id for x in profiling.RECORDER.spans if x.name == root}
    children = [x for x in profiling.RECORDER.spans if x.parent is not None]
    assert children and all(x.parent in roots for x in children)
    assert {x.name for x in profiling.RECORDER.spans if x.parent is None} == (
        {"render", "frame.bytes"} if name == "splat_serve"
        else {"stacked.batch.build", "stacked.batch.upload", "stacked.step"})
    stages = sum(got[m]["value"] for m in NEW_METRICS[name] if m.endswith("_ms." + name.split("_")[-1]))
    covered = stages + s[root]["self_ms"] / r["trace_units"]
    assert covered <= 1e3 * r["trace_s"] / r["trace_units"]
    if name == "splat_serve":
        assert got["sort_slots_per_row.serve"]["value"] >= 1.0


@pytest.mark.parametrize("metric", sorted(m for ms in NEW_METRICS.values() for m in ms))
def test_span_readers_without_the_recorder(metric, monkeypatch):
    """Each reader finds nothing in empty readings, nor in a port without
    the recorder (the parent commit's), and divides by the slice's units."""
    from perfbench import core

    mod = core.load_module(ROOT / "perfbench" / "metrics" / f"{metric}.py", "t_" + metric.replace(".", "_"))
    assert mod.read({}) is None
    with _cpu_profile():
        for _ in range(2):
            with span("stacked.step" if metric.endswith("stacked") else "render"):
                for n in ("render.project", "render.bin", "render.gather", "render.composite", "frame.bytes",
                          "stacked.batch.build", "stacked.batch.upload", "stacked.encode", "stacked.decode",
                          "stacked.loss", "stacked.backward", "stacked.optimizer"):
                    with span(n):
                        pass
        count("render.slots_sorted", 300)
        count("render.rows_used", 100)
        count(SYNCS, 8)
    value = mod.read({"trace_units": 2})
    if "syncs" in metric:
        assert value == 4.0
    elif "slots" in metric:
        assert value == 3.0
    else:
        assert 0.0 <= value < 1.0
    monkeypatch.delattr(profiling, "summary")
    assert mod.read({"trace_units": 2}) is None


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: these tests run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and their host syncs exist only on the card)")
    return torch.device("cuda")


# The host synchronisations of one served view, by the span that holds
# them: bin_stream's two masked writes (``stream_gauss[pos[in_budget]] =
# sorted_gauss[in_budget]`` and the chunk map's ``[is_cs]`` pair), each mask
# a nonzero count read on the host, two apiece, and ``covered[chunk_tile] =
# True``, whose Python scalar is copied to the card from pageable memory;
# used_stream's ``int(n_padded)``; image_to_bytes' copy of the frame to the
# host.
SERVE_SYNCS = {"render.bin": 5, "render.gather": 1, "frame.bytes": 1}


@pytest.mark.gpu
def test_served_view_syncs_match_their_sites(cuda):
    scene, cam = _scene(4000, 0, cuda), _camera(320, 240, cuda)
    _serve(scene, cam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(2):
            profiling.reset()
            _serve(scene, cam)
            torch.cuda.synchronize()  # outside every span: not counted
            s = summary()
            assert {n: r["syncs"] for n, r in s["spans"].items() if r["syncs"]} == SERVE_SYNCS
            assert s["counters"][SYNCS] == sum(SERVE_SYNCS.values())
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
def test_span_encloses_k1_launch_on_the_device_clock(cuda):
    """A span around K1's launch encloses the CUDA runtime call that
    launched it and the kernel's start, in the profiler's CUDA trace."""
    s = _prepared(_scene(4000, 0, cuda), _camera(320, 240, cuda))
    props, ct = s.props(), s.chunk_tile
    launch = lambda: stream_mod.composite_stream_tiles(props, ct, s.binned.tile_counts, s.grid_w, s.grid_h)  # noqa: E731
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("k1") as k1:
            launch()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type() == cuda_type and "stream_fwd" in e.name()]
    assert len(kernels) == 1, [e.name() for e in events if e.device_type() == cuda_type]
    k = kernels[0]
    calls = [e for e in events if e.device_type() != cuda_type and e.correlation_id() == k.correlation_id()
             and e.name().startswith("cu")]
    assert len(calls) == 1, [(e.name(), e.correlation_id()) for e in events if e.name().startswith("cu")]
    call = calls[0]
    assert k1.start_ns <= call.start_ns() <= call.start_ns() + call.duration_ns() <= k1.end_ns
    assert k1.start_ns <= call.start_ns() <= k.start_ns()


def test_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
    assert isinstance(device_memory_stats(), dict)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_step_report_keys(precision):
    rep = roofline.step_report(dict(COUNTS, precision=precision), measured_ms={"fwd_kernel": 0.67, "total": 25.0})
    assert set(rep) == set(STAGES) | {"_total"}
    for name in STAGES:
        row = rep[name]
        assert {"roofline_ms", "bound", "t_bytes_ms", "t_ops_ms"} <= set(row)
        assert row["bound"] in ("bytes", "operations")
        assert row["roofline_ms"] == max(row["t_bytes_ms"], row["t_ops_ms"]) > 0
    assert rep["fwd_kernel"]["roofline_frac"] == pytest.approx(rep["fwd_kernel"]["roofline_ms"] / 0.67)
    assert "measured_ms" not in rep["project"]
    assert rep["_total"]["roofline_ms"] == pytest.approx(sum(rep[n]["roofline_ms"] for n in STAGES))
    assert rep["_total"]["measured_ms"] == 25.0


def test_bf16_rows_count_half_the_bytes():
    f32 = roofline.fwd_kernel(1000, 10, 4096, 4, "fp32")
    b16 = roofline.fwd_kernel(1000, 10, 4096, 4, "bf16")
    assert f32.nbytes - b16.nbytes == 4096 * 32 and f32.ops == b16.ops
    g32 = roofline.bwd_kernel(1000, 10, 4096, 8192, 4, "fp32")
    g16 = roofline.bwd_kernel(1000, 10, 4096, 8192, 4, "bf16")
    assert g32.nbytes - g16.nbytes == 4096 * 32  # the gradient rows stay float32


def _printed_interval(fn, walked, live):
    """The bounds over the rounding intervals of counts given to 0.1M."""
    lo = fn(walked - 0.05e6, live - 0.05e6).roofline_ms
    hi = fn(walked + 0.05e6, live + 0.05e6).roofline_ms
    return lo, hi


def test_kernel_bounds_reproduce_perf_md():
    """PERF.md's K1 row: 431.4M walked pairs x 14 + 109.4M contributing x 6
    = 0.1000 ms; K2's: 536.7M x 14 + 238.7M x 41 = 0.2582 ms, both bound by
    operations. The counts there are rounded to 0.1M, so the bounds over
    their rounding intervals must hold the printed values."""
    k1 = lambda w, c: roofline.fwd_kernel(w, c, 2_310_000, 8160)  # noqa: E731
    k2 = lambda w, c: roofline.bwd_kernel(w, c, 2_310_000, 3_014_656, 8160)  # noqa: E731
    for fn, walked, live, printed in ((k1, 431.4e6, 109.4e6, 0.1000), (k2, 536.7e6, 238.7e6, 0.2582)):
        lo, hi = _printed_interval(fn, walked, live)
        assert lo < printed + 0.00005 and hi >= printed - 0.00005, (lo, hi, printed)
        assert fn(walked, live).bound == "operations"
    assert roofline.bwd_kernel(536.7e6, 238.7e6, 0, 0, 0).roofline_ms == pytest.approx(0.2582, abs=5e-5)


def test_chip_smoke_takes_its_bounds_from_the_module(monkeypatch):
    assert chip_smoke.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert chip_smoke.bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
    for name in ("PEAK_BYTES_PER_S", "PEAK_FP32_FLOPS", "PEAK_BF16_FLOPS", "WALK_OPS_PER_PAIR",
                 "K1_OPS_PER_LIVE", "K2_OPS_PER_LIVE", "K3_OPS_PER_PIXEL", "K4_OPS_PER_PIXEL", "K6_OPS_PER_LIVE"):
        assert getattr(chip_smoke, name) is getattr(roofline, name), name
    monkeypatch.setattr(roofline, "PEAK_FP32_FLOPS", 134e12)
    assert chip_smoke.bound(1.0, 67e9) == (pytest.approx(0.5), "operations")
