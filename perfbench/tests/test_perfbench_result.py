"""The result line's schema, the import guard, and the run's refusal
without a card."""

import json
import subprocess
import sys
import types

from perfbench import core

from conftest import ROOT


def test_forbidden_names_compare_whole():
    assert core.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert core.forbidden_modules(["gaussian_transformer_tpu.render"]) == ["gaussian_transformer_tpu"]
    assert core.forbidden_modules(["gaussian_transformer_tpu_torch.render", "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["optax", "orbax.checkpoint", "jaxlib"]) == ["jaxlib", "optax", "orbax"]


def _result():
    return {"correct": True, "attempted": 10, "failed": 0,
            "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                       "memory_peak_bytes": 123}}


def test_last_line_schema(capsys):
    checks = {"loss_gap": {"value": 1e-6, "limit": 1e-4}}
    assert core.finish(_result(), checks) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["checks"] == checks
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert err.strip().splitlines()[-1] == "check loss_gap: 1e-06 limit 0.0001"


def test_guard_refuses_a_result_with_jax_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert core.finish(_result(), {}) != 0
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_run_without_a_card_prints_no_result():
    """This sandbox has no CUDA card: the run exits non-zero, no result."""
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "splat_serve", "--seed", "5",
                        "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_in_a_checkout_without_the_port_fails(tmp_path):
    """BENCHMARK.json and perfbench/ alone: the run cannot import the port."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy; sys.argv = ['perfbench/run.py', '--workload', 'splat_serve', '--seed', '5', "
            "'--seconds', '1']; import torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; torch.cuda.get_device_name = lambda i=0: 'x'; "
            "runpy.run_path('perfbench/run.py', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "gaussian_transformer_tpu_torch" in p.stderr
