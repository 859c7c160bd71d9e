"""The 15-subset sweep of a volume (segmentation and reconstruction under
every modality subset), in a closed loop.

Set-up makes a pool of synthetic volumes on the device and the model's
weights and BatchNorm statistics from the seed, builds the program's model
in eval mode and its hoisted sweep (`make_hoisted_subset_sweep`, patch =
stride = crop, as the eval CLI builds it), and runs it `warmup` times. The
window sweeps the pool's volumes in turn, synchronised after each. One
sweep drawn from the seed among the first `draw_from` runs with a
`stages.Recorder` on the model, which keeps, on the device, the output of
every stage in its hoisted prefix and under `subsets_checked` subsets
drawn from the seed; that sweep and the window's last keep their outputs.
Once the window has closed and the program is freed, the plain reference,
in fp32 with TF32 off, follows the drawn sweep stage by stage from the
program's own values (the prefix once, then each checked subset), and
reconstructs both kept sweeps' volumes under the checked subsets, plain,
in fp32 and at the configuration's bf16 (the yardstick of `recon_gap_x`).

Traffic parameters: "crop", "pool", "warmup", "draw_from",
"subsets_checked".
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

from perfbench import harness, stages, synthetic
from perfbench.drivers import program
from perfbench.reference import model as ref_model
from perfbench.reference import step as ref_step
from perfbench.reference.precision import strict_fp32


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_inputs(cell, seed: int, device):
    tr = cell.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    x, _ = synthetic.pool(gen, tr["pool"], tr["crop"])
    wg, _ = program.make_weights(cell.config, gen, disc=False)
    return x[:, None], wg


def build_sweep(cell, wg, device):
    from xlstm_hved_torch.engine import evaluate

    model, _ = program.build_program(cell.config, wg, None, device)
    model.eval()
    crop = tuple(cell.traffic["crop"])
    sweep = evaluate.make_hoisted_subset_sweep(model, crop, crop, recon_channels=4)
    return model, sweep


def drawn_sweep(seed: int, tr: dict) -> int:
    gen = torch.Generator().manual_seed(seed)
    return int(torch.randint(tr["draw_from"], (1,), generator=gen))


def checked_subsets(seed: int, tr: dict) -> List[int]:
    gen = torch.Generator().manual_seed(seed + 1)
    return sorted(torch.randperm(15, generator=gen)[:tr["subsets_checked"]].tolist())


def stage_plan(config: dict):
    """(the model's stages, the ViL's among them) by name, from the
    reference's module tree."""
    g, _ = program.reference_modules(config, "meta", disc=False)
    names = stages.stage_names(g, ref_model.ViL3D)
    return names, [n for n in names if isinstance(g.get_submodule(n), ref_model.ViL3D)]


def recorder(plan, model, subsets) -> stages.Recorder:
    """A Recorder of the sweep's stages (`stage_plan`): the hoisted prefix,
    and the forwards of the checked subsets (told by their keep masks)."""
    names, vil = plan
    wanted = set(subsets)

    def phase_of(kwargs, count):
        if kwargs.get("mode") == "prefix":
            return "prefix"
        keep = kwargs.get("keep")
        if keep is None:
            return None
        s = ref_step.SUBSETS.index(tuple(i for i, k in enumerate(keep.tolist()) if k))
        return s if s in wanted else None

    return stages.Recorder(model, names, phase_of, inputs=vil)


def follow(cell, x, wg, records, seg, rec, device, subsets) -> Dict[str, float]:
    """The reference's sweep of x followed stage by stage from the
    program's recorded values: its full forward once (the prefix's stages
    compared), then each checked subset's forward on the masked volume (the
    prefix handed on, the rest compared), and each subset's outputs against
    the sweep's (`output.seg`, `output.recon`). Each gap by stage name."""
    names, vil = stage_plan(cell.config)
    with strict_fp32(), torch.no_grad():
        g, _ = program.build_reference(cell.config, wg, None, device)
        g.eval()
        f = stages.Follower(g, names, records, vil)
        f.start("prefix")
        g(x, torch.ones(4, dtype=torch.bool))
        gaps = {}
        for s in subsets:
            f.start(s, fallback="prefix")
            keep = ref_step.keep_mask(s, x.device)
            out = g(x * keep.to(x.dtype).reshape(1, -1, 1, 1, 1), keep.cpu())
            for name, mine, theirs in (("output.seg", out.seg, seg[s]),
                                       ("output.recon", out.recon, rec[s])):
                gaps[name] = max(gaps.get(name, 0.0), stages.rel_l2(theirs, mine))
        f.remove()
    del g
    gaps.update(f.gaps)
    return gaps


def recon_gaps(cell, x, wg, kept: Dict[object, Tuple], device, subsets) -> Dict[str, float]:
    """The worst relative L2 distance of a kept sweep's reconstruction, over
    its checked subsets, to the plain fp32 reference's (`recon_gap`), and
    the same in units of the bf16 reference's own distance to the fp32 one
    on that output (`recon_gap_x`)."""
    raw, scaled = [], []
    with strict_fp32():
        g, _ = program.build_reference(cell.config, wg, None, device)
        yard, _ = program.build_reference(cell.config, wg, None, device, "bfloat16")
        for v, _, rec in kept.values():
            pairs = zip(ref_step.sweep(g, x[v], subsets), ref_step.sweep(yard, x[v], subsets))
            for (s, _, rrec), (_, _, yrec) in pairs:
                raw.append(stages.rel_l2(rec[s], rrec))
                scaled.append(raw[-1] / max(stages.rel_l2(yrec, rrec), 1e-30))
    del g, yard
    nan_first = lambda u: float("inf") if u != u else u  # noqa: E731
    return {"recon_gap": max(raw, key=nan_first), "recon_gap_x": max(scaled, key=nan_first)}


def numbers(followed: Dict[str, float], recon: Dict[str, float], vil) -> Dict[str, float]:
    """- stage_gap: the worst stage of the drawn sweep (its outputs among
      them), followed from the program's own values, the ViL's apart but
      for its input (`<stage>.in`);
    - vil_gap: the worst ViL block from the program's own input, against
      the block's own change;
    - recon_gap, recon_gap_x: `recon_gaps`."""
    return {"stage_gap": stages.worst(followed, [k for k in followed if k not in vil]),
            "vil_gap": stages.worst(followed, list(vil)), **recon}


def flops_per_sweep(cell, x, wg, device) -> float:
    """The reference's operations for one sweep: 15 plain forwards."""
    from torch.utils.flop_counter import FlopCounterMode

    with strict_fp32(), torch.no_grad():
        g, _ = program.build_reference(cell.config, wg, None, device)
        counter = FlopCounterMode(display=False)
        with counter:
            next(ref_step.sweep(g, x, [14]))
    return 15.0 * counter.get_total_flops()


def check(cell, x, wg, kept, records, device, subsets):
    """Every number of the kept sweeps (`numbers`) and the gaps by stage."""
    v, seg, rec = kept["drawn"]
    followed = follow(cell, x[v], wg, records, seg, rec, device, subsets)
    program.free(device)
    recon = recon_gaps(cell, x, wg, kept, device, subsets)
    return numbers(followed, recon, stage_plan(cell.config)[1]), followed


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> harness.Window:
    tr = cell.traffic
    x, wg = make_inputs(cell, seed, device)
    model, sweep = build_sweep(cell, wg, device)
    for i in range(tr["warmup"]):
        sweep(model, x[i % tr["pool"]])
    _sync(device)
    setup_s = time.perf_counter() - t0

    drawn, subsets = drawn_sweep(seed, tr), checked_subsets(seed, tr)
    plan = stage_plan(cell.config)
    kept: Dict[str, Tuple] = {}
    records = {}
    times, failed, n = [], 0, 0
    tracer = harness.Trace() if trace else contextlib.nullcontext()
    with tracer:
        start = time.perf_counter()
        while True:
            v = n % tr["pool"]
            rec_hooks = recorder(plan, model, subsets) if n == drawn else None
            t = time.perf_counter()
            seg, rec = sweep(model, x[v])
            finite = bool(torch.isfinite(seg).all()) and bool(torch.isfinite(rec).all())
            times.append(time.perf_counter() - t)
            failed += not finite
            if rec_hooks is not None:
                rec_hooks.remove()
                records = rec_hooks.records
                kept["drawn"] = (v, seg, rec)
            kept["last"] = (v, seg, rec)
            n += 1
            if time.perf_counter() - start >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    del model, sweep, seg, rec
    program.free(device)
    t = time.perf_counter()
    if "drawn" not in kept:  # a window too short to reach the drawn sweep
        kept["drawn"] = kept["last"]
    got, _ = check(cell, x, wg, kept, records, device, subsets)
    flops = flops_per_sweep(cell, x[0], wg, device) if trace else None
    check_s = time.perf_counter() - t
    checks = {k: (got[k], lim) for k, lim in cell.limits.items()}
    return harness.Window(units=n, window_s=window_s, setup_s=setup_s, unit_times=times,
                          memory_peak_bytes=peak, checks=checks, attempted=n, failed=failed,
                          trace=tracer if trace else None, flops_per_unit=flops,
                          notes={"drawn": drawn, "subsets": subsets, "readings": got,
                                 "check_s": check_s})
