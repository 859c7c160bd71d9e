"""Readings for the limits of a cell's correctness check, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds S1 S2 ... [--control N] [--out F]

For each seed, the program's numbers against the plain reference, as a run
computes them (without the window). For the first N seeds also the
control's: the reference in fp8 with its ViL in bf16
(`reference/precision.py`), put in the program's place; and, for the
training step, its faults: "unchanged" (a step that leaves the state as it
was: no run needed, its change reads 1), "altered" (the program with G's
segmentation inverted, 1 - p, where it is produced), and "yardstick" (the
reference at the configurations' bf16 in the program's place, for the
change alone: what the stated precision does to the change's worst leaf).
One JSON line per seed and side; the limits file of the cell is set from
them (PERF.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "perfbench"):
    sys.path[0] = ROOT


def altered(model):
    """The module with its forward's segmentation inverted (1 - p) where it
    is produced."""
    forward = model.forward
    model.forward = lambda *a, **k: (lambda out: out._replace(seg=1.0 - out.seg))(
        forward(*a, **k))
    return model


def train_seed(cell, seed, device, emit, control: bool):
    from perfbench import harness
    from perfbench.drivers import program
    from perfbench.drivers import train_step as ts

    n, checked = cell.traffic["first_steps"], cell.traffic["checked_steps"]
    x, mask, wg, wd = ts.make_inputs(cell, seed, device)

    def run_program(fault=None):
        state, step = ts.build_step(cell, wg, wd, seed, device)
        if fault:
            fault(state.model)
        side = ts.program_first_steps(cell, state, step, x, mask, wg, wd, n, checked)
        del state, step
        program.free(device)
        return side

    def judge(name, side):
        got, _, followed = ts.check(cell, x, mask, wg, wd, seed, device, side)
        top = sorted(followed.items(), key=lambda kv: -kv[1])[:5]
        emit(seed, name, got, top)
        program.free(device)
        return got

    judge("program", run_program())
    if not control:
        return
    judge("control", ts.reference_first_steps(cell, x, mask, wg, wd, seed, device, checked,
                                              "float8", record=True)[0])
    emit(seed, "unchanged", {"change_gap": 1.0, "change_gap_median": 1.0}, [])
    judge("altered", run_program(altered))
    ref, _ = ts.reference_first_steps(cell, x, mask, wg, wd, seed, device, checked)
    yard, _ = ts.reference_first_steps(cell, x, mask, wg, wd, seed, device, checked, "bfloat16")
    still = ts.still_leaves(ref.grad1)
    worst = max(ts.by_model(harness.worst_leaf, yard.change, ref.change, still, name=True))
    emit(seed, "yardstick", {"change_gap": worst[0], "change_leaf": worst[1],
                             "change_gap_median": ts.by_model(harness.median_leaf,
                                                              yard.change, ref.change, still)},
         [])
    program.free(device)


def sweep_seed(cell, seed, device, emit, control: bool):
    from perfbench.drivers import program
    from perfbench.drivers import sweep as sw

    # the program as a run drives it, its first window sweep followed
    one = dataclasses.replace(cell, traffic=dict(cell.traffic, draw_from=1))
    w = sw.run(one, seed, 1e-3, False, device, time.perf_counter())
    emit(seed, "program", w.notes["readings"], [])
    program.free(device)
    if not control:
        return
    x, wg = sw.make_inputs(cell, seed, device)
    subsets = sw.checked_subsets(seed, cell.traffic)
    seg, rec, records = control_sweep(cell, x[0], wg, device, subsets)
    got, followed = sw.check(cell, x, wg, {"drawn": (0, seg, rec), "last": (0, seg, rec)},
                             records, device, subsets)
    emit(seed, "control", got, sorted(followed.items(), key=lambda kv: -kv[1])[:5])
    program.free(device)


def control_sweep(cell, x, wg, device, subsets):
    """The control in the sweep's place: the fp8 reference, one plain
    forward on the whole volume x (its prefix), then one on the masked
    volume per checked subset, its stages recorded as the program's are.
    (seg, recon) as the sweep returns them (the other subsets zero), and
    the records."""
    import torch

    from perfbench.drivers import program
    from perfbench.drivers import sweep as sw
    from perfbench.reference import step as ref_step
    from perfbench.reference.precision import strict_fp32

    with strict_fp32(), torch.no_grad():
        ctl, _ = program.build_reference(cell.config, wg, None, device, "float8")
        ctl.eval()
        phase = {"now": "prefix"}
        hooks = sw.recorder(sw.stage_plan(cell.config), ctl, subsets)
        hooks.phase_of = lambda kwargs, count: phase["now"]
        ctl(x, torch.ones(4, dtype=torch.bool))
        seg = torch.zeros((15, x.shape[0], 3) + tuple(x.shape[2:]), device=device)
        rec = torch.zeros((15,) + tuple(x.shape), device=device)
        for s in subsets:
            phase["now"] = s
            keep = ref_step.keep_mask(s, device)
            out = ctl(x * keep.to(x.dtype).reshape(1, -1, 1, 1, 1), keep.cpu())
            seg[s], rec[s] = out.seg, out.recon
        hooks.remove()
        del ctl
    program.free(device)
    return seg, rec, hooks.records


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

    run = train_seed if cell.traffic["driver"] == "train_step" else sweep_seed
    for i, seed in enumerate(args.seeds):
        run(cell, seed, device, emit, i < args.control)
    if out:
        out.close()


if __name__ == "__main__":
    main()
