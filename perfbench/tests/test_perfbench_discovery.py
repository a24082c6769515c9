"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every cell's configuration, traffic, driver and metric readers are files,
and a new cell and a new metric need new files only."""

import json
import re
import shutil

import pytest

from perfbench import core

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return core.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and bench["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = core.Cell(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert (ROOT / "perfbench" / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        for m in cell.per_layer:
            assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(cell.traffic["limits"])


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path, bench):
    """A copy of the benchmark gains a cell (a traffic file on an existing
    driver) and a per-layer metric (a reader file) without an edit to any
    file it had; only BENCHMARK.json gains entries."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((ROOT / "perfbench/traffic/splat_serve.json").read_text())
    traffic["views"]["count"] = 16
    (tmp_path / "perfbench/traffic/splat_serve_small_pool.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench/metrics/views_seen.serve.py").write_text(
        "def read(r):\n    return r.get('views')\n")
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "splat_serve_small_pool", "config": "splat_1m_sh3_1080p",
                           "traffic": "splat_serve_small_pool", "chips": 1, "why": "a dummy cell"})
    b["end_to_end"][[m["name"] for m in b["end_to_end"]].index("view_p95_ms")]["workloads"].append(
        "splat_serve_small_pool")
    b["per_layer"].append({"name": "views_seen.serve", "unit": "views", "better": "higher",
                           "source": "host_clock", "layer": "serving path", "moves": "view_p95_ms",
                           "workloads": ["splat_serve_small_pool"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = core.Cell(core.load_benchmark(tmp_path), "splat_serve_small_pool", root=tmp_path)
    assert cell.traffic["views"]["count"] == 16
    assert cell.driver().__name__ == "perfbench_driver_splat_serve"
    assert [m["name"] for m in cell.end_to_end] == ["view_p95_ms", "setup_s"]
    got = cell.read_per_layer({"views": 7})
    assert got["views_seen.serve"] == {"value": 7.0, "unit": "views"}
    # A reader that finds nothing leaves its metric out of the line.
    assert "k1_roofline.serve" not in got


def test_each_reader_finds_nothing_in_empty_readings(bench):
    for m in bench["per_layer"]:
        mod = core.load_module(ROOT / "perfbench" / "metrics" / f"{m['name']}.py", "t_" + m["name"])
        assert mod.read({}) is None, m["name"]
