"""Readings for setting a cell's correctness limits: the compared numbers
of sound runs of the port on many seeds, of the cell's control (the
reference in the next lower precision put in the port's place), and of runs
with a fault of ``perfbench/faults.py`` planted in the port, each seed's
readings one JSON line on standard output.

    python3 perfbench/calibrate.py --workload splat_train --seeds 11 12 13 --seconds 2
    python3 perfbench/calibrate.py --workload splat_train --seeds 11 12 13 --control
    python3 perfbench/calibrate.py --workload splat_train --seeds 11 12 13 --seconds 2 --fault half_batch

The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import core, faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", help="a fault of perfbench/faults.py planted for every seed")
    args = ap.parse_args(argv)
    core.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("perfbench: calibration needs a CUDA card", file=sys.stderr)
        return 2
    cell = core.Cell(core.load_benchmark(), args.workload)
    driver = cell.driver()
    dev = torch.device("cuda")
    patcher = faults.Patcher()
    if args.fault:
        faults.FAULTS[args.workload][args.fault](patcher)
    for seed in args.seeds:
        t = time.perf_counter()
        if args.control:
            out = driver.control(cell, seed, dev)
        else:
            out = driver.run(cell, seed, args.seconds, False, dev, t)
        line = {"workload": args.workload, "seed": seed, "control": args.control, "fault": args.fault,
                "checks": {k: c["value"] for k, c in out["checks"].items()},
                "seconds": time.perf_counter() - t, "detail": out.get("detail")}
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    patcher.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
