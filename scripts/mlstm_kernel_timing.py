#!/usr/bin/env python3
"""Time the three mLSTM kernel wrappers of one checkout of the port, and hold
them against their plain twins.

    python3 scripts/mlstm_kernel_timing.py [--root CHECKOUT] [--cases S4096 S196_DH384 ...]
                                           [--save OUT.pt]
    python3 scripts/mlstm_kernel_timing.py --compare A.pt B.pt

For mlstm_fwd (`run_kernel`), mlstm_fwd_states (`run_states_kernel`) and
mlstm_bwd (`run_bwd_kernel`) at the named cases of `chip_smoke.KERNEL_CASES`
(default: `chip_smoke.TIMED_CASES`, the narrow and the wide path's timed
shapes), it prints for each kernel:
- "call_ms": one call with the host in it (the wrapper's Python checks,
  allocations and ctypes call, then its launches), `chip_smoke.cuda_ms`;
- "device_ms": the device time of one call, 20 calls enqueued behind a
  device-side wait, `chip_smoke.device_ms`;
- "bound_ms", `chip_smoke.bound_ms` of `chip_smoke.mlstm_cost` (or
  `mlstm_bwd_cost`), and device_ms over it;
- "scaled_err": max|kernel - twin| / max|twin| over the kernel's outputs
  (h; h, C*, n*; dq, dk, dv, ds, dax), phase 3's measure.
The timers, inputs (seeded per case, so every checkout gets the same ones),
costs and twins come from this checkout's `chip_smoke.py`; the kernels from
the checkout at --root (default: this one), so that two versions, e.g. an
unpacked parent commit and this tree, are timed the same way on one card
(run them in turns: parent, this, this, parent). A checkout whose wrappers
take the true length (`seq_len`) gets it, as `mlstm_forward` passes it; the
cotangent is zero past S for every checkout. --save writes every case's
outputs (h, the entry states, the five gradients, keyed "<case>/<name>") to
a file; --compare says, for each key of two such files, whether it holds
the same bits and its max|d| (two versions whose sums run in another order
differ within the bounds), and exits 1 unless all are the same. --profile
adds each CUDA kernel's device µs per call (`chip_smoke.launch_us`) and
ptxas's registers and spills. Needs a CUDA card (not for --compare).
Prints the card's name and power limit first and, last, one JSON object
with the numbers.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(path_a: str, path_b: str) -> int:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    same = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    diffs = {}
    for key in sorted(a):
        equal = key in b and torch.equal(a[key], b[key])
        diffs[key] = float((a[key] - b[key]).abs().max()) if key in b else None
        print(f"  {key}: {'bitwise equal' if equal else 'DIFFERENT'}, max|d| {diffs[key]}")
    print(json.dumps({"compare": [path_a, path_b], "bitwise_equal": same, "max_abs_diff": diffs}))
    return 0 if same else 1


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE,
                        help="checkout whose xlstm_hved_torch is timed (default: this one)")
    parser.add_argument("--cases", nargs="+", default=None,
                        help="labels of chip_smoke.KERNEL_CASES (default: its TIMED_CASES)")
    parser.add_argument("--save", default=None,
                        help="write every case's outputs here (torch.save)")
    parser.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"))
    parser.add_argument("--profile", action="store_true",
                        help="also print each CUDA kernel's device time per call "
                             "(torch.profiler over 10 calls) and ptxas's report")
    args = parser.parse_args()
    if args.compare:
        sys.exit(compare(*args.compare))
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # this checkout's timers, before --root joins the path

    cases = {c[0]: c[1:] for c in cs.KERNEL_CASES}
    labels = args.cases or list(cs.TIMED_CASES)
    unknown = [x for x in labels if x not in cases]
    if unknown:
        cs.fail(f"unknown cases {unknown}; chip_smoke.KERNEL_CASES has {sorted(cases)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from xlstm_hved_torch.ops import mlstm_cuda as mc
    from xlstm_hved_torch.utils import cuda_build

    if not os.path.abspath(mc.__file__).startswith(root + os.sep):
        cs.fail(f"imported {mc.__file__}, not the checkout at {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    report = cuda_build.build(mc.SOURCES)
    if args.profile:
        for name, rep in report.items():
            for line in cs.ptxas_report(rep["log"]):
                print(f"  {name}: {line}", flush=True)
    takes_length = "seq_len" in inspect.signature(mc.run_kernel).parameters

    result, saved = {}, {}
    for label in labels:
        B, NH, S, DH, kind = cases[label]
        gen = torch.Generator(device=dev).manual_seed(sorted(cases).index(label))
        q, k, v, ig, fg = cs.mlstm_inputs(gen, dev, B, NH, S, DH, kind)
        prepared = mc.prepare(q, k, v, ig, fg, 128)
        qf, kf, vf, a, s, cm = prepared
        BH, Sp, DP = qf.shape
        L = a.shape[-1]
        g = torch.randn(qf.shape, generator=gen, device=dev)
        g[..., DH:] = 0.0
        g.view(B * NH, Sp, DP)[:, S:] = 0.0
        length = {"seq_len": S} if takes_length else {}
        with torch.inference_mode():
            ref_states = mc.mlstm_forward_states_reference(*prepared, dh=DH)
            bwd_args = (qf, kf, vf, g, a, s, cm, *ref_states[1:])
            ref_grads = mc.mlstm_backward_reference(*bwd_args, dh=DH)
            calls = {"mlstm_fwd": lambda: mc.run_kernel(*prepared, dh=DH, **length),
                     "mlstm_fwd_states": lambda: mc.run_states_kernel(*prepared, dh=DH,
                                                                      **length),
                     "mlstm_bwd": lambda: mc.run_bwd_kernel(*bwd_args, dh=DH, **length)}
            outs = {name: fn() for name, fn in calls.items()}
            torch.cuda.synchronize()
            refs = {"mlstm_fwd": (ref_states[0],), "mlstm_fwd_states": ref_states[:3],
                    "mlstm_bwd": ref_grads}
            if args.save:
                outputs = {"h": outs["mlstm_fwd"], "states_h": outs["mlstm_fwd_states"][0],
                           "cent": outs["mlstm_fwd_states"][1],
                           "nent": outs["mlstm_fwd_states"][2],
                           "ment": outs["mlstm_fwd_states"][3],
                           **dict(zip(("dq", "dk", "dv", "ds", "dax"), outs["mlstm_bwd"]))}
                saved.update({f"{label}/{key}": t.cpu() for key, t in outputs.items()})
            costs = {"mlstm_fwd": cs.mlstm_cost(BH, S, DH, L),
                     "mlstm_fwd_states": cs.mlstm_cost(BH, S, DH, L, states=True),
                     "mlstm_bwd": cs.mlstm_bwd_cost(BH, S, DH, L)}
            for name, fn in calls.items():
                got = outs[name] if name != "mlstm_fwd" else (outs[name],)
                err = max(cs.scaled_err(x, r) for x, r in zip(got, refs[name]))
                bound, by = cs.bound_ms(*costs[name])
                row = {"call_ms": cs.cuda_ms(fn), "device_ms": cs.device_ms(fn),
                       "bound_ms": bound, "bound_by": by, "scaled_err": err}
                row["over_bound"] = row["device_ms"] / bound
                if args.profile:
                    row["launches_us"] = cs.launch_us(fn)
                result[f"{name}_{label}"] = row
                print(f"  {name} {label}: one call {row['call_ms']:.4f} ms, device "
                      f"{row['device_ms']:.4f} ms, bound {bound:.5f} ms by {by} "
                      f"({row['over_bound']:.2f}x), scaled err {err:.3e}", flush=True)
                if args.profile:
                    print("    " + ", ".join(f"{k} {us:.1f} us" for k, us in
                                             row["launches_us"].items()), flush=True)
        del outs, ref_states, ref_grads, bwd_args, prepared
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    print(json.dumps({"root": root, "nvidia_smi": smi, "seq_len": takes_length,
                      "kernels": result}))


if __name__ == "__main__":
    main()
