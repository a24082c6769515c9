"""Whole runs of each cell at a tiny size on the CPU (the drivers, past
``run.py``'s look for a card): sound, ``correct`` holds; with the timed path
broken underneath (``perfbench/faults.py``: a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; a batch
or a served frame altered where it is produced), it comes out false."""

import importlib
import time

import pytest
import torch

from perfbench import core
from perfbench.faults import FAULTS

from conftest import KEPT_OUT, tiny_cell

SEED = 3_000_000_019


def _run(name, trace=False):
    cell = tiny_cell(name)
    driver = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter())
    return out, all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", ["splat_train", "splat_serve", "stacked_train"])
def test_sound_run_is_correct(name):
    out, correct = _run(name)
    assert correct, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", ["splat_train", "splat_serve"])
def test_traced_run_reads_per_layer_metrics(name):
    out, correct = _run(name, trace=True)
    assert correct
    r = out["readings"]
    assert r["trace_units"] > 0 and r["trace_s"] > 0 and r["untraced_s"] > 0
    if name in KEPT_OUT:
        return
    cell = core.Cell(core.load_benchmark(), name)
    got = cell.read_per_layer(r)
    # On the CPU no device kernel runs: the trace's readers find nothing.
    assert not any(k.startswith(("k1_", "k2_", "gemm_")) for k in got)


# At the tiny size every camera sees the whole scene, so a batch made
# without one of its cameras is the same batch; that fault is read at the
# cell's own size alone (``calibrate.py --fault``).
CASES = [(cell, name) for cell, faults in FAULTS.items() for name in faults if name != "camera_missing"]


@pytest.mark.parametrize("name, fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[name][fault](monkeypatch)
    out, correct = _run(name)
    assert not correct, out["checks"]
