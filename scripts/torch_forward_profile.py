#!/usr/bin/env python3
"""Where the time of the PyTorch port's flagship forward goes on one CUDA card.

    python3 scripts/torch_forward_profile.py [--crop D H W] [--iters N] [--seed S]

Builds XLSTM_HVED (fp32, TF32 off, seeded random weights) on cuda:0 and runs
the seg+recon forward with deterministic latents on one (1, 4, D, H, W)
window. Prints, after the card's name and power limit:
- the forward's median time (CUDA events, nothing else attached);
- per top-level module group, the device time between CUDA events recorded
  by forward hooks at its entry and exit (kernels plus any gaps between
  them), summed over the group, and the rest of the forward ("glue": PoE,
  reparametrisation, upsampling and adds in the model's own body);
- from one torch.profiler window of N forwards: device busy time per
  forward (the sum of kernel times), the idle share of the forward's wall
  time, and the kernels that take the most device time.
The last line is one JSON object with the same numbers.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = (("encoders", "encoders_"), ("drb", "drb_"), ("vu", "vu_"),
          ("vu", "conv_block_"), ("skip_return", "skr_"), ("skip_return", "x0_init"),
          ("vil", "mvil"), ("seg_decoder", "sdecoder_"), ("recon_decoder", "rdecoder_"),
          ("duse", "dusfe_"), ("heads", "rfinal_"), ("heads", "sfinal_"),
          ("heads", "final_conv"), ("stem", "init_blocks"))


def group_of(name: str) -> str:
    for group, prefix in GROUPS:
        if name.startswith(prefix):
            return group
    raise KeyError(name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crop", type=int, nargs=3, default=(128, 128, 128))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from xlstm_hved_torch.models import find_model_using_name

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand(1, 4, *args.crop, generator=gen, device=dev)

    def forward():
        return model(x, recon=True, deterministic=True)

    def timed(fn, n):
        times = []
        for _ in range(n):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    with torch.inference_mode():
        for _ in range(3):
            forward()
        forward_ms = timed(forward, args.iters)

        # per-module device spans from events recorded by forward hooks
        spans = collections.defaultdict(list)
        handles = []
        for name, module in model.named_children():
            def pre(mod, inp, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                spans[name].append([ev, None])

            def post(mod, inp, out, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                spans[name][-1][1] = ev

            handles.append(module.register_forward_pre_hook(pre))
            handles.append(module.register_forward_hook(post))
        hooked_ms = timed(forward, args.iters)
        for h in handles:
            h.remove()
        by_group = collections.Counter()
        for name, pairs in spans.items():
            by_group[group_of(name)] += sum(s.elapsed_time(e) for s, e in pairs) / args.iters
        by_group["glue"] = hooked_ms - sum(by_group.values())

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                forward()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.iters
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]

    print(f"forward {tuple(args.crop)}: {forward_ms:.3f} ms (median of {args.iters}); "
          f"with module hooks {hooked_ms:.3f} ms")
    for group, ms in by_group.most_common():
        print(f"  {group:14s} {ms:8.3f} ms  {100 * ms / hooked_ms:5.1f} %")
    print(f"device busy {busy_ms:.3f} ms per forward, idle share "
          f"{1 - busy_ms / forward_ms:.3f} of {forward_ms:.3f} ms")
    for e in top:
        ms = e.self_device_time_total / 1e3 / args.iters
        print(f"  {ms:8.3f} ms  x{e.count // args.iters:<4d} {e.key[:110]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "crop": list(args.crop), "forward_ms": forward_ms, "hooked_ms": hooked_ms,
        "groups_ms": dict(by_group), "busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / forward_ms,
        "top_kernels_ms": {e.key[:110]: e.self_device_time_total / 1e3 / args.iters
                           for e in top}}))


if __name__ == "__main__":
    main()
