"""Readings for the limits of a cell's correctness check, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds S1 S2 ... [--control N] [--out F]

For each seed, the cell's driver (`perfbench/drivers/<driver>.py`) gives
its readings through its `calibrate_seed(cell, seed, device, emit,
control)`: the program's numbers against the plain reference, as a run
computes them (without the window), and for the first N seeds also the
control's, the reference at the precision below the configuration's put
in the program's place, and the driver's planted faults (the training
step's and the sweep's drivers say which). One JSON line per seed and
side; the limits file of the cell is set from them (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "perfbench"):
    sys.path[0] = ROOT

from perfbench.drivers.sweep import control_sweep  # noqa: E402,F401
from perfbench.drivers.train_step import altered  # noqa: E402,F401


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="read the control (and the faults) on the first N seeds")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--crop", type=int, nargs=3, default=None,
                   help="a smaller crop, for a rehearsal on the CPU")
    args = p.parse_args(argv)
    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if args.crop:
        cell.traffic = dict(cell.traffic, crop=args.crop)
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else None

    def emit(seed, side, numbers, top):
        line = json.dumps({"workload": cell.name, "seed": seed, "side": side,
                           "numbers": numbers, "top": top, "t": time.time()})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    run = getattr(harness.driver(cell.traffic), "calibrate_seed", None)
    if run is None:
        raise SystemExit(f"perfbench: the driver {cell.traffic['driver']!r} of {cell.name} "
                         "has no calibrate_seed(cell, seed, device, emit, control)")
    for i, seed in enumerate(args.seeds):
        run(cell, seed, device, emit, i < args.control)
    if out:
        out.close()


if __name__ == "__main__":
    main()
