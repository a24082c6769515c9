"""The port's profiling and roofline utilities (utils/profiling.py,
utils/roofline.py), as tests/test_aux.py holds the JAX package's: the step
timer's EMA, a trace written on the CPU, no memory stats without a card;
the step report's keys, the K1/K2 bounds on PERF.md's pair counts, and
``chip_smoke.py``'s bounds taken from the module. Imports no JAX."""

import json
import os
import time

import pytest
import torch

import chip_smoke
from gaussian_transformer_tpu_torch.utils import profiling, roofline
from gaussian_transformer_tpu_torch.utils.profiling import StepTimer, annotate, device_memory_stats, trace

COUNTS = {"n_gaussians": 1_200_000, "n_instances": 3_276_800, "i_pad": 3_014_656, "real_rows": 2_310_000,
          "n_tiles": 8160, "height": 1080, "width": 1920, "walked": 536_700_000, "contributing": 238_700_000}
STAGES = ("project", "bin", "gather", "fwd_kernel", "bwd_kernel", "loss_adam")


def test_step_timer_ema():
    t = StepTimer(ema=0.5)
    with t:
        time.sleep(0.01)
    first = t.ema_ms
    assert first >= 10
    with t:
        time.sleep(0.03)
    assert t.ema_ms > first
    assert t.last_ms >= 30
    assert t.ema_ms == pytest.approx(0.5 * t.last_ms + 0.5 * first)


def test_trace_produces_files(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("matmul_span"):
            torch.ones(128, 128) @ torch.ones(128, 128)
    found = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert len(found) == 1 and found[0].endswith(".pt.trace.json")
    with open(tmp_path / found[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul_span" for e in events)
    assert any(e.key == "matmul_span" for e in prof.key_averages())


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
