#!/usr/bin/env python3
"""Where the time of the PyTorch port's flagship forward, or of its train step, goes on one CUDA card.

    python3 scripts/torch_forward_profile.py [--crop D H W] [--iters N] [--seed S]
    python3 scripts/torch_forward_profile.py --train [--crop D H W] [--iters N]
    ... [--plain-mlstm]   the same through the plain PyTorch mLSTM (no kernels)

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
  time, the kernels that take the most device time, and each CUDA kernel of
  the mLSTM (one call of a wrapper is three of them) with its time per
  launch and its launches per forward.
The last line is one JSON object with the same numbers.

With --train it builds the train step instead (G as above with the
Discriminator(64, 4), TrainConfig defaults, init "reference", a seeded
synthetic batch) and splits one step into its phases with CUDA events: the
two G forwards, D's forward inside the G loss, the rest of the loss, the G
backward, the G optimizer step, the D step's two forwards, its backward and
its optimizer step (medians over N steps; the phases replay the engine's own
functions in the engine's order), beside the median of the engine's
make_train_step and the profiler's busy time, idle share, top kernels and
mLSTM kernels over N engine steps.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = (("encoders", "encoders_"), ("drb", "drb_"), ("vu", "vu_"),
          ("vu", "conv_block_"), ("skip_return", "skr_"), ("skip_return", "x0_init"),
          ("vil", "mvil"), ("seg_decoder", "sdecoder_"), ("recon_decoder", "rdecoder_"),
          ("duse", "dusfe_"), ("heads", "rfinal_"), ("heads", "sfinal_"),
          ("heads", "final_conv"), ("stem", "init_blocks"))


def mlstm_kernels(kernels, iters):
    """{name: (ms per launch, launches per call)} of the mLSTM's CUDA
    kernels among the profiler's device events."""
    found = ((re.search(r"mlstm_[a-z_]+_kernel<\d+>", e.key), e) for e in kernels)
    return {m.group(0): (e.self_device_time_total / 1e3 / e.count, e.count // iters)
            for m, e in found if m}


def print_mlstm(launches, per: str):
    for name, (ms, count) in sorted(launches.items()):
        print(f"  {name:30s} {1e3 * ms:9.2f} us per launch  x{count} per {per}")


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
    ap.add_argument("--train", action="store_true", help="break down a train step")
    ap.add_argument("--plain-mlstm", action="store_true",
                    help="run the mLSTM through the plain PyTorch scan, not the kernels")
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
    if args.train:
        return train_breakdown(args, dev, smi)
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=args.seed,
                                  mlstm_kernel=False if args.plain_mlstm else None)
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
    mlstm = mlstm_kernels(kernels, args.iters)

    print(f"forward {tuple(args.crop)}: {forward_ms:.3f} ms (median of {args.iters}); "
          f"with module hooks {hooked_ms:.3f} ms")
    for group, ms in by_group.most_common():
        print(f"  {group:14s} {ms:8.3f} ms  {100 * ms / hooked_ms:5.1f} %")
    print(f"device busy {busy_ms:.3f} ms per forward, idle share "
          f"{1 - busy_ms / forward_ms:.3f} of {forward_ms:.3f} ms")
    for e in top:
        ms = e.self_device_time_total / 1e3 / args.iters
        print(f"  {ms:8.3f} ms  x{e.count // args.iters:<4d} {e.key[:110]}")
    print("mLSTM kernels:")
    print_mlstm(mlstm, "forward")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "plain_mlstm": args.plain_mlstm, "crop": list(args.crop), "forward_ms": forward_ms, "hooked_ms": hooked_ms,
        "groups_ms": dict(by_group), "busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / forward_ms,
        "top_kernels_ms": {e.key[:110]: e.self_device_time_total / 1e3 / args.iters
                           for e in top},
        "mlstm_kernels_ms_per_launch": {n: ms for n, (ms, _) in mlstm.items()}}))


def profile_busy(fn, iters):
    """(device busy ms per call, the top kernels' ms per call, the mLSTM
    kernels) from one torch.profiler window of `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return busy_ms, [(e.key[:110], e.self_device_time_total / 1e3 / iters, e.count // iters)
                     for e in top], mlstm_kernels(kernels, iters)


def train_breakdown(args, dev, smi):
    import torch

    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine import train as engine
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.utils.subsets import sample_subset_index, subset_mask

    cfg = TrainConfig(crop_size=tuple(args.crop))
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=args.seed,
                                  mlstm_kernel=False if args.plain_mlstm else None)
    disc = Discriminator(f_maps=cfg.disc_f_maps, kernel=cfg.disc_kernel)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand(1, 4, *args.crop, generator=gen, device=dev)
    mask = (torch.rand(1, 3, *args.crop, generator=gen, device=dev) > 0.8).float()
    state = engine.create_train_state(model, disc, cfg, args.seed, x, init_scheme="reference")
    loss_g = engine._g_objective(model, disc, cfg)
    loss_d = engine.make_loss_d(disc, cfg)
    params_g, params_d = list(model.parameters()), list(disc.parameters())

    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hooks = [m.register_forward_pre_hook(lambda mod, inp, n=n: mark(f"{n}+"))
             for n, m in (("G", model), ("D", disc))]
    hooks += [m.register_forward_hook(lambda mod, inp, out, n=n: mark(f"{n}-"))
              for n, m in (("G", model), ("D", disc))]

    def phased_step():
        """The engine's step, phase by phase (no freeze mask)."""
        marks.clear()
        keep = subset_mask(sample_subset_index(state.rng, 1, 3), dev)
        lr = engine.poly_schedule(cfg.learning_rate, cfg.num_epochs, 1)(state.step)
        mark("start")
        disc.requires_grad_(False)
        loss, aux = loss_g(x, mask, keep, state.latent_rng)
        mark("g_loss")
        grads = engine._grads(loss, params_g)
        disc.requires_grad_(True)
        mark("g_backward")
        engine._step(state.opt_g, params_g, grads, lr)
        mark("g_optimizer")
        del loss, grads
        ld = loss_d(aux)
        mark("d_forwards")
        grads_d = engine._grads(ld, params_d)
        mark("d_backward")
        engine._step(state.opt_d, params_d, grads_d, lr)
        mark("d_optimizer")
        state.step += 1
        torch.cuda.synchronize()
        t, opened = {}, {}
        fwd = {"G": [], "D": []}  # forward spans from the hooks, in order
        prev = marks[0][1]
        for label, e in marks[1:]:
            if label.endswith("+"):
                opened[label[0]] = e
            elif label.endswith("-"):
                fwd[label[0]].append(opened.pop(label[0]).elapsed_time(e))
            else:
                t[label] = prev.elapsed_time(e)
                prev = e
        g_fwd, d_fwd = fwd["G"], fwd["D"]
        return {"g_forward_all_modalities": g_fwd[0], "g_forward_subset": g_fwd[1],
                "d_forward_in_g_loss": d_fwd[0],
                "g_loss_rest": t["g_loss"] - sum(g_fwd) - d_fwd[0],
                "g_backward": t["g_backward"], "g_optimizer": t["g_optimizer"],
                "d_forwards": t["d_forwards"], "d_backward": t["d_backward"],
                "d_optimizer": t["d_optimizer"], "step": sum(t.values())}

    phased_step()
    runs = [phased_step() for _ in range(args.iters)]
    for h in hooks:
        h.remove()
    phases = {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    step = engine.make_train_step(model, disc, cfg)

    def engine_step():
        nonlocal state
        state, _ = step(state, x, mask)

    engine_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        engine_step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy_ms, top, mlstm = profile_busy(engine_step, args.iters)

    path = "the plain mLSTM" if args.plain_mlstm else "the mLSTM kernels"
    print(f"train step {tuple(args.crop)} through {path}: {step_ms:.3f} ms (engine, median of {args.iters}), "
          f"peak {peak_gib:.2f} GiB; phased replay {phases['step']:.3f} ms")
    for name, ms in phases.items():
        if name != "step":
            print(f"  {name:26s} {ms:9.3f} ms  {100 * ms / phases['step']:5.1f} %")
    print(f"device busy {busy_ms:.3f} ms per step, idle share "
          f"{1 - busy_ms / step_ms:.3f} of {step_ms:.3f} ms")
    for key, ms, count in top:
        print(f"  {ms:8.3f} ms  x{count:<4d} {key}")
    print("mLSTM kernels:")
    print_mlstm(mlstm, "step")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "mode": "train",
        "plain_mlstm": args.plain_mlstm, "crop": list(args.crop), "step_ms": step_ms, "peak_gib": peak_gib,
        "phases_ms": phases, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / step_ms,
        "top_kernels_ms": {k: ms for k, ms, _ in top},
        "mlstm_kernels_ms_per_launch": {n: ms for n, (ms, _) in mlstm.items()}}))


if __name__ == "__main__":
    main()
