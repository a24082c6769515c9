"""Shared by the benchmark's own tests: cells cut to a size the CPU runs in
seconds (the drivers take any device; ``perfbench/run.py`` alone insists on
a card)."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_VIEWS = {"count": 6, "width": 96, "height_px": 64}

# Cells whose driver and traffic are kept while a fault of the program keeps
# them out of BENCHMARK.json (PERF.md, Open questions), and their config.
KEPT_OUT = {"splat_train": "splat_1m_sh3_1080p"}


def tiny_cell(name: str):
    """The committed cell ``name`` with its sizes cut for the CPU: 3,000
    Gaussians and 96x64 views for the splatting cells; STACK 3 (d_model
    208), one layer, 600 Gaussians and 64x48 views for the stacked ones."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in bench["workloads"]}.get(name) or {"config": KEPT_OUT[name], "traffic": name}
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    cfg = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["views"].update(TINY_VIEWS)
    if name.startswith("splat"):
        cfg["gaussians"] = 3000
        traffic.update(warmup_steps=4, trace_steps=3, min_requests=20, trace_views=3)
    else:
        cfg.update(stack=3, d_model=208, layers=1, gaussians=600)
        traffic["views"].update(width=64, height_px=48)
        traffic.update(batch=2, pool_batches=2, min_batches=3, trace_seconds=0.3, warmup_steps=4)
    return SimpleNamespace(name=name, config=cfg, traffic=traffic)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: the test runs only on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell's own size runs only on the card)")
    return torch.device("cuda")
