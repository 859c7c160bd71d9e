#!/usr/bin/env python3
"""Time the three mLSTM kernel wrappers of one checkout of the port, two ways.

    python3 scripts/mlstm_kernel_timing.py [--root CHECKOUT] [--lengths 4096 6144]

For mlstm_fwd (`run_kernel`), mlstm_fwd_states (`run_states_kernel`) and
mlstm_bwd (`run_bwd_kernel`) at the flagship's shapes (B*NH 4, DH 16, chunk
128, realistic gates), it prints:
- "call_ms": one call with the host in it (the wrapper's Python checks,
  allocations and ctypes call, then its launches), `chip_smoke.cuda_ms`;
- "device_ms": the device time of one call, 20 calls enqueued behind a
  device-side wait, `chip_smoke.device_ms`.
The timing functions come from this checkout's `chip_smoke.py`; the kernels
from the checkout at --root (default: this one), so that two versions of
the kernels, e.g. an unpacked parent commit and this tree, are timed the
same way on one card. Needs a CUDA card. Prints the card's name and power
limit first and, last, one JSON object with the same numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE,
                        help="checkout whose xlstm_hved_torch is timed (default: this one)")
    parser.add_argument("--lengths", type=int, nargs="+", default=[4096, 6144])
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # this checkout's timers, before --root joins the path

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
    cuda_build.build(mc.SOURCES)

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {}
    for S in args.lengths:
        prepared = mc.prepare(*cs.mlstm_inputs(gen, dev, 1, 4, S, 16, "realistic"), 128)
        g = torch.randn(prepared[0].shape, generator=gen, device=dev)
        with torch.inference_mode():
            entry = mc.run_states_kernel(*prepared, dh=16)[1:]
            bwd_args = (*prepared[:3], g, *prepared[3:], *entry)
            calls = {"mlstm_fwd": lambda: mc.run_kernel(*prepared, dh=16),
                     "mlstm_fwd_states": lambda: mc.run_states_kernel(*prepared, dh=16),
                     "mlstm_bwd": lambda: mc.run_bwd_kernel(*bwd_args, dh=16)}
            for name, fn in calls.items():
                row = {"call_ms": cs.cuda_ms(fn), "device_ms": cs.device_ms(fn)}
                result[f"{name}_S{S}"] = row
                print(f"  {name} S {S}: one call {row['call_ms']:.4f} ms, device "
                      f"{row['device_ms']:.4f} ms", flush=True)
    print(json.dumps({"root": root, "nvidia_smi": smi, "kernels": result}))


if __name__ == "__main__":
    main()
