"""What every cell of the benchmark shares: finding a cell's files by name,
the import guard, the card's description, the profiler's reduction to busy
time, kernel sums and idle gaps, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
``configs[].file`` (the sizes), ``perfbench/traffic/<traffic>.json`` (the
mix, whose ``driver`` names ``perfbench/drivers/<driver>.py``) and one reader
``perfbench/metrics/<metric>.py`` per per-layer metric. A later cell or
metric is a new file, never an edit.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# Top-level module names that may not be loaded in a measured process:
# JAX, its libraries and the JAX package. Compared whole, so the port
# (``gaussian_transformer_tpu_torch``) passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gaussian_transformer_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Kernel caches at fixed paths inside the checkout, so only a
    checkout's first run builds (the port's nvcc libraries already live in
    ``build/torch_kernels/``)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with everything found by its names."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = by_name[name]
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        with open(root / entry["file"]) as f:
            self.config = json.load(f)
        with open(root / "perfbench" / "traffic" / f"{self.workload['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.root = root
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if m["moves"] in reported and applies(m, name)]

    def driver(self):
        d = self.traffic["driver"]
        return load_module(self.root / "perfbench" / "drivers" / f"{d}.py", f"perfbench_driver_{d}")

    def read_per_layer(self, readings: dict) -> Dict[str, dict]:
        """Each per-layer metric's reader on the run's readings; a reader
        that finds nothing returns None and its metric is left out."""
        out = {}
        for m in self.per_layer:
            path = self.root / "perfbench" / "metrics" / f"{m['name']}.py"
            value = load_module(path, "perfbench_metric_" + m["name"].replace(".", "_")).read(readings)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


# ---------------------------------------------------------------- numbers

def percentile(values, q: float) -> float:
    """The nearest-rank percentile (q in [0, 100]): a value that was read."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def rel_gap(a: float, b: float, floor: float = 0.0) -> float:
    """|a - b| over max(|b|, floor)."""
    den = max(abs(b), floor)
    return abs(a - b) / den if den > 0 else (0.0 if a == b else math.inf)


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return math.inf
    med = statistics.median(ref[k] for k in names)
    return max(rel_gap(prog[k], ref[k], med) for k in names)


def training_checks(prog: dict, refr: dict, limits: dict, steps: int) -> dict:
    """A training cell's compared numbers: the worst step's loss gap; the
    worst leaf's gap of the first gradient's norm and of its change after
    the last checked step, each against the larger of that leaf's and the
    median leaf's reference norm. Leaves whose reference gradient is under
    a thousandth of the median leaf's (a key's bias under softmax, say)
    move by round-off alone and are left out."""
    med = statistics.median(refr["grad"].values())
    keep = [k for k, v in refr["grad"].items() if v >= 1e-3 * med]
    whole = len(prog["losses"]) == len(refr["losses"]) == steps
    loss = max(rel_gap(a, b) for a, b in zip(prog["losses"], refr["losses"])) if whole else math.inf
    return {"loss_gap": {"value": loss, "limit": limits["loss_gap"]},
            "grad_gap": {"value": norm_gaps(prog["grad"], refr["grad"], keep), "limit": limits["grad_gap"]},
            "delta_gap": {"value": norm_gaps(prog["delta"], refr["delta"], keep), "limit": limits["delta_gap"]}}


# ---------------------------------------------------------------- the card

def nvidia_smi() -> Optional[str]:
    """One line: name, power limit, SM clock, power draw, temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def power_limit_w(line: Optional[str]) -> Optional[float]:
    try:
        return float(line.split(",")[1].strip().split()[0])
    except (AttributeError, IndexError, ValueError):
        return None


def device_record(torch, smi_line: Optional[str], peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak_bytes), "power_limit_w": power_limit_w(smi_line)}


# ---------------------------------------------------------------- the trace

class Trace:
    """``torch.profiler`` over a short slice of the window (started and
    stopped by the driver), reduced to what the per-layer readers need."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        # The card's activity alone (kernels, copies and the CUDA runtime
        # calls that issue them): recording every host op as well slows a
        # launch-bound host by half again and more, which the idle share
        # would then read as the program's.
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def summary(self) -> dict:
        """busy_s: the union of device activity; kernels: {name: [count,
        seconds]}; device_ops and idle_gaps: the ten largest, the gaps named
        by the innermost CUDA runtime call under each gap's start."""
        CUDA = self.torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if _annotation(e):
                continue  # a named range over other events, not work of its own
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            (dev if e.device_type() == CUDA else host).append(span)
        dev.sort()
        kernels: Dict[str, list] = {}
        for s, t, name in dev:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (t - s) * 1e-9
        busy, gaps, end = 0, [], None
        for s, t, _ in dev:
            if end is None or s > end:
                if end is not None:
                    gaps.append((end, s))
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        host.sort()
        starts = [h[0] for h in host]
        by_host: Dict[str, float] = {}
        for g0, g1 in gaps:
            i = bisect.bisect_right(starts, g0)
            covering = [h for h in host[max(0, i - 256):i] if g0 < h[1]]
            name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "(host, between CUDA calls)"
            by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-9
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {
            "busy_s": busy * 1e-9,
            "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in top],
            "idle_gaps": sorted(([n, s] for n, s in by_host.items()), key=lambda x: -x[1])[:10],
        }


def _annotation(event) -> bool:
    """A user annotation (a named range, on the host or the card); torch
    versions differ in which of these two accessors they have."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_seconds(kernels: Dict[str, list], *needles: str) -> float:
    """Device seconds of the kernels whose names hold any of ``needles``
    (letter case ignored)."""
    return sum(v[1] for n, v in kernels.items() if any(x.lower() in n.lower() for x in needles))


# cuBLAS and CUTLASS matrix products and their reductions, by kernel name.
GEMM_NAMES = ("gemm", "gemv", "splitkreduce")


def kernel_count(kernels: Dict[str, list]) -> int:
    """Device kernels (copies and fills left out)."""
    return sum(v[0] for n, v in kernels.items() if not n.startswith(("Memcpy", "Memset")))


# ---------------------------------------------------------------- the line

def finish(result: dict, checks: Dict[str, dict]) -> int:
    """Print the compared numbers beside their limits (standard error, as
    the last lines) and the result line (standard output, last), after the
    import guard. Returns the exit code."""
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded in the measured process: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    # Strict JSON has no infinities: a number that could not be read shows
    # as a string.
    finite = lambda v: v if math.isfinite(v) else str(v)
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    print(json.dumps(result), flush=True)
    return 0
