"""Run one cell of the port's benchmark on this machine's card and print its
result line.

    python3 perfbench/run.py --workload splat_train --seed 7 --seconds 20 --trace 0

``--trace 0`` measures the cell's end-to-end metrics with no tracing;
``--trace 1`` profiles a short slice at the window's end and prints the
per-layer metrics. Every run then checks what the timed path produced
against ``perfbench/reference`` and prints each compared number beside its
limit. The last line of standard output is one JSON object.

Exits non-zero with no result when there is no CUDA card (or fewer than the
cell asks for), when the port cannot be imported, or when JAX, a JAX
library or the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import core  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    core.set_cache_dirs()
    # One host thread for CPU tensor ops: the port's host work is one Python
    # thread, and idle worker threads only contend with it on a shared host.
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    cell = core.Cell(core.load_benchmark(), args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    smi = core.nvidia_smi()
    print(f"card before the window: {smi}", file=sys.stderr)
    out = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T_START)
    print(f"card after the window: {core.nvidia_smi()}", file=sys.stderr)
    print("detail " + json.dumps(out.get("detail", {})), file=sys.stderr)

    r = out["readings"]
    if args.trace:
        metrics = cell.read_per_layer(r)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {name: {"value": float(values[name]), "unit": unit} for name, unit in units.items()}
    device = core.device_record(torch, smi, out["memory_peak_bytes"])
    result = {"correct": all(c["value"] <= c["limit"] for c in out["checks"].values()),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if args.trace:
        t = r["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], r["trace_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    return core.finish(result, out["checks"])


if __name__ == "__main__":
    sys.exit(main())
