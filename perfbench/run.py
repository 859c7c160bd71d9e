"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding `BENCHMARK.json`, `perfbench/` and the
program (`xlstm_hved_torch/`). The cell's driver makes its inputs and
weights from the seed, warms up (set-up, timed from the start of this
process), runs its closed loop for `--seconds`, frees the program and checks
what the window produced against the plain reference. With `--trace 0` the
result line holds the cell's end-to-end metrics; with `--trace 1` the window
runs under torch.profiler and the line holds the per-layer metrics, the
device's busy seconds and the breakdown. The numbers compared, each with its
limit, are the last lines on standard error and the last key of the line.
No card (or fewer than the cell asks for), or a JAX module loaded by the
end of the window: no result line, and a non-zero exit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "perfbench"):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics_of(cell, w, trace: bool):
    """The cell's end-to-end metrics (trace 0) or per-layer ones (trace 1)."""
    from types import SimpleNamespace

    from perfbench import harness

    out = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = w.setup_s
            elif m["name"] == cell.traffic["unit_metric"]:
                value = 1e3 * w.window_s / w.units
            else:
                continue
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    ctx = SimpleNamespace(trace=w.trace, units=w.units, config=cell.config,
                          traffic=cell.traffic, flops_per_unit=w.flops_per_unit)
    for m in cell.per_layer:
        value = harness.reader(m["name"].split(".")[0]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import harness

    cell = harness.load_cell(args.workload)
    harness.require_card(cell.chips)
    import importlib

    import torch

    driver = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")
    w = driver.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; no result", file=sys.stderr)
        return 4
    q1, med, q3 = harness.quartiles(w.unit_times)
    times = sorted(w.unit_times)
    p95 = times[min(len(times) - 1, int(0.95 * len(times)))]
    print(f"perfbench: {cell.name} seed {args.seed}: {w.units} units in {w.window_s!r} s; "
          f"per unit median {med!r} s, p95 {p95!r} s, quartiles {q1!r} / {q3!r}, "
          f"set-up {w.setup_s!r} s; {w.notes}", file=sys.stderr)
    line = {
        "correct": harness.correct(w.checks) and w.failed == 0,
        "attempted": w.attempted,
        "failed": w.failed,
        "metrics": metrics_of(cell, w, bool(args.trace)),
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(w.memory_peak_bytes)},
    }
    if args.trace:
        mlstm = sorted({k[0][:80] for k in w.trace.kernels if "mlstm" in k[0]})
        print(f"perfbench: mLSTM kernels in the window: {mlstm}", file=sys.stderr)
        line["device"]["busy_s"] = w.trace.busy_s()
        line["device"]["window_s"] = w.trace.window_s
        line["breakdown"] = w.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in w.checks.items()}
    for k, (v, lim) in w.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
