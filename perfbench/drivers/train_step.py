"""The adversarial G + D training step, in a closed loop.

Set-up makes a pool of synthetic volumes on the device and G's and D's
weights from the seed, builds the program's train state (`TrainState`,
`make_optimizer`, `make_train_step`, as the train CLI does, with the
step's generators made from the seed), and drives it through its first
steps on distinct volumes: the warm-up, and the steps the reference
follows. In the first step a `stages.Recorder` keeps, on the host, the
output of every stage of G in both of its forwards (and G's outputs) and
of D in its three calls; after it, the BatchNorm running statistics. Of
the first `checked_steps`: each step's drawn subset, the first gradient as
Adam took it (from its first moment after step 1), and each leaf's change
as the last of them left it. The window then runs the same step on the
pool in turn, each step's losses read back as the CLI reads them. After
the window the program is freed and the plain reference, in fp32 with TF32
off, follows the first step stage by stage from the program's own values
(its forwards, its loss terms, its BatchNorm statistics), and runs the
checked steps from the same weights, inputs and generators.

Traffic parameters: "crop" (D, H, W), "batch", "pool" (volumes made),
"first_steps" (warm-up steps), "checked_steps" (the first of them the
reference follows), "steps_per_epoch" (the poly schedule's epoch).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from perfbench import harness, stages, synthetic
from perfbench.drivers import program
from perfbench.reference import model as ref_model
from perfbench.reference import step as ref_step
from perfbench.reference.precision import strict_fp32

LOSS_KEYS = ("loss", "dice", "m_dice", "recon", "kld", "g_gan", "loss_d")
BETA1 = 0.9
STATS = ("running_mean", "running_var")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _change(model, w0) -> Dict[str, float]:
    return {n: float((p.detach() - w0[n]).double().norm()) for n, p in model.named_parameters()}


def _stats(model) -> Dict[str, torch.Tensor]:
    return {n: b.detach().float().cpu().clone() for n, b in model.named_buffers()
            if n.endswith(STATS)}


class Readings:
    """What the first steps leave, on either side: losses and subsets per
    step, the first gradient's leaf norms, each leaf's change, the
    BatchNorm statistics after the first step, and the first step's stage
    outputs of G and of D (`stages.Recorder`)."""

    def __init__(self):
        self.losses: List[Dict[str, float]] = []
        self.subsets: List[int] = []
        self.grad1: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.stats1: Dict[str, torch.Tensor] = {}
        self.records_g: Dict[tuple, list] = {}
        self.records_d: Dict[tuple, list] = {}


def generators(seed: int, device):
    return (torch.Generator().manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed + 1))


def make_inputs(cell, seed: int, device):
    tr = cell.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    x, mask = synthetic.pool(gen, tr["pool"] * tr["batch"], tr["crop"])
    shape = (tr["pool"], tr["batch"]) + tuple(x.shape[1:])
    x, mask = x.view(shape), mask.view(shape[:2] + tuple(mask.shape[1:]))
    wg, wd = program.make_weights(cell.config, gen, disc=True)
    return x, mask, wg, wd


def build_step(cell, wg, wd, seed, device):
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine import train as engine

    g, d = program.build_program(cell.config, wg, wd, device)
    tcfg = TrainConfig(**{k: v for k, v in cell.config["train"].items()
                          if k != "steps_per_epoch"})
    rng, latent_rng = generators(seed, device)
    state = engine.TrainState(model=g, disc=d, opt_g=engine.make_optimizer(g.parameters(), tcfg),
                              opt_d=engine.make_optimizer(d.parameters(), tcfg),
                              rng=rng, latent_rng=latent_rng)
    step = engine.make_train_step(g, d, tcfg, cell.traffic["steps_per_epoch"])
    return state, step


def read_metrics(metrics) -> Dict[str, float]:
    """The loss terms in one device-to-host copy, as the train CLI reads them."""
    vals = torch.stack([metrics[k].float() for k in LOSS_KEYS]).tolist()
    out = dict(zip(LOSS_KEYS, vals))
    out["subset_idx"] = int(metrics["subset_idx"])
    return out


def stage_plan(config: dict):
    """(G's stages and its outputs "", D's stages, the ViL stages) by name,
    from the reference's module tree."""
    g, d = program.reference_modules(config, "meta", disc=True)
    names_g = stages.stage_names(g, ref_model.ViL3D)
    vil = [n for n in names_g if isinstance(g.get_submodule(n), ref_model.ViL3D)]
    return names_g + [""], stages.stage_names(d, ref_model.ViL3D), vil


def _g_phase(kwargs, count):
    return count if count < 2 else None  # the full forward, then the subset's


def _d_phase(kwargs, count):
    return count if count < 3 else None  # D in G's objective, then on fake, on real


def recorders(config: dict, g, d) -> tuple:
    """Recorders of the first step's stages of G and D, kept on the host."""
    names_g, names_d, vil = stage_plan(config)
    host = torch.device("cpu")
    return (stages.Recorder(g, names_g, _g_phase, host, inputs=vil),
            stages.Recorder(d, names_d, _d_phase, host))


def _moment_norms(opt, model) -> Dict[str, float]:
    return {n: float(opt.state[p]["exp_avg"].double().norm()) / (1 - BETA1)
            for n, p in model.named_parameters()}


def program_first_steps(cell, state, step, x, mask, wg, wd, n: int, checked: int) -> Readings:
    """Run n steps on the pool's first n volumes; the readings of the first
    `checked` (the change as step `checked` left it)."""
    r = Readings()
    rec_g, rec_d = recorders(cell.config, state.model, state.disc)
    for i in range(n):
        state, metrics = step(state, x[i], mask[i])
        m = read_metrics(metrics)
        r.subsets.append(m.pop("subset_idx"))
        r.losses.append(m)
        if i == 0:
            rec_g.remove()
            rec_d.remove()
            r.records_g, r.records_d = rec_g.records, rec_d.records
            r.stats1 = _stats(state.model)
            r.grad1 = {**{f"G.{k}": v for k, v in _moment_norms(state.opt_g, state.model).items()},
                       **{f"D.{k}": v for k, v in _moment_norms(state.opt_d, state.disc).items()}}
        if i == checked - 1:
            r.change = {**{f"G.{k}": v for k, v in _change(state.model, wg).items()},
                        **{f"D.{k}": v for k, v in _change(state.disc, wd).items()}}
    r.subsets, r.losses = r.subsets[:checked], r.losses[:checked]
    return r


def _train(cell) -> dict:
    return dict(cell.config["train"], steps_per_epoch=cell.traffic["steps_per_epoch"])


def reference_first_steps(cell, x, mask, wg, wd, seed, device, n: int,
                          precision: str = "float32", flops: bool = False, record: bool = False):
    """The reference's Readings over the first n steps (with `record`, its
    first step's stages kept as the program's are: the control in the
    program's place), and with `flops` the operations its first step
    counted (forward and backward, G and D)."""
    from torch.utils.flop_counter import FlopCounterMode

    with strict_fp32():
        g, d = program.build_reference(cell.config, wg, wd, device, precision)
        ref = ref_step.ReferenceStep(g, d, _train(cell))
        rng, latent_rng = generators(seed, device)
        r = Readings()
        rec = recorders(cell.config, g, d) if record else ()
        counted = None
        for i in range(n):
            if flops and i == 0:
                counter = FlopCounterMode(display=False)
                with counter:
                    m = ref.step(x[i], mask[i], rng, latent_rng)
                counted = float(counter.get_total_flops())
            else:
                m = ref.step(x[i], mask[i], rng, latent_rng)
            r.subsets.append(m.pop("subset_idx"))
            r.losses.append(m)
            if i == 0:
                for h in rec:
                    h.remove()
                if record:
                    r.records_g, r.records_d = rec[0].records, rec[1].records
                r.stats1 = _stats(g)
                r.grad1 = {**{f"G.{k}": v for k, v in zip(ref.g_names, ref_step.leaf_norms(
                               ref_step.first_gradient(ref.opt_g)))},
                           **{f"D.{k}": v for k, v in zip(ref.d_names, ref_step.leaf_norms(
                               ref_step.first_gradient(ref.opt_d)))}}
        r.change = {**{f"G.{k}": v for k, v in _change(g, wg).items()},
                    **{f"D.{k}": v for k, v in _change(d, wd).items()}}
    del g, d, ref
    return r, counted


def follow_first_step(cell, x, mask, wg, wd, seed, device, side: Readings) -> Dict[str, float]:
    """The reference's first step, forwards and loss terms, followed stage
    by stage from `side`'s recorded values (`stages.Follower`): each
    stage's gap, by name ("G." / "D." and the stage; "G." alone is G's
    outputs), each loss term's relative gap ("loss.<term>"), and each
    BatchNorm statistic's ("stats.<buffer>": the distance of the side's
    change after the first step to the reference's, against the larger of
    that change and the median buffer's)."""
    names_g, names_d, vil = stage_plan(cell.config)
    with strict_fp32():
        g, d = program.build_reference(cell.config, wg, wd, device)
        ref = ref_step.ReferenceStep(g, d, _train(cell))
        fg = stages.Follower(g, names_g, side.records_g, vil, _g_phase)
        fd = stages.Follower(d, names_d, side.records_d, (), _d_phase)
        losses = ref.losses(x[0], mask[0], *generators(seed, device))
        fg.remove()
        fd.remove()
        stats = _stats(g)
    del g, d, ref
    gaps = {**{f"G.{k}": v for k, v in fg.gaps.items()},
            **{f"D.{k}": v for k, v in fd.gaps.items()}}
    first = side.losses[0]
    gaps.update({f"loss.{k}": harness.rel_gap(first[k], losses[k]) for k in LOSS_KEYS})
    w0 = {n: wg[n].float().cpu() for n in stats}
    moved = {n: float((stats[n] - w0[n]).norm()) for n in stats}
    floor = sorted(moved.values())[len(moved) // 2] if moved else 0.0
    gaps.update({f"stats.{n}": float((side.stats1[n] - stats[n]).norm())
                 / max(moved[n], floor, 1e-30) for n in stats})
    return gaps


def numbers(side: Readings, ref: Readings, followed: Dict[str, float], vil) -> Dict[str, float]:
    """The numbers the checked steps give, a side (the program, or the
    control in its place) against the reference:
    - subsets: drawn subsets that differ (exact);
    - stage_gap: the worst stage of G (outputs among them) and of D in the
      first step, followed from the side's own values (`follow_first_step`),
      the ViL's apart but for its input (`<stage>.in`);
    - vil_gap: the worst ViL block from the side's own input, against the
      block's own change;
    - loss_gap: the worst relative gap of the first step's loss terms, the
      side's against the reference's from the side's own values;
    - stats_gap: the worst BatchNorm statistic after the first step, so
      followed;
    - change_gap / change_gap_median: the worst / the median leaf of the
      gap of each leaf's change over the checked steps, each leaf against
      the larger of its own reference norm and its model's median leaf's,
      less the leaves whose reference gradient is under 1e-3 of their
      model's median leaf's (they move by rounding alone); change_leaf
      names the worst."""
    still = still_leaves(ref.grad1)
    worst = max((by_model(harness.worst_leaf, side.change, ref.change, still, name=True)),
                key=lambda t: t[0])
    vil_keys = {f"G.{n}" for n in vil}
    plain = [k for k in followed if k[:2] in ("G.", "D.") and k not in vil_keys]
    return {
        "subsets": float(sum(a != b for a, b in zip(side.subsets, ref.subsets))),
        "stage_gap": stages.worst(followed, plain),
        "vil_gap": stages.worst(followed, sorted(vil_keys)),
        "loss_gap": stages.worst(followed, [k for k in followed if k.startswith("loss.")]),
        "stats_gap": stages.worst(followed, [k for k in followed if k.startswith("stats.")]),
        "change_gap": worst[0],
        "change_gap_median": max(x[0] for x in by_model(harness.median_leaf, side.change,
                                                        ref.change, still, name=True)),
        "change_leaf": worst[1],
    }


def compare(got: Dict[str, float], limits: dict):
    """The numbers with a limit in the cell's limits file, each (value,
    limit), with `subsets` always (limit 0)."""
    checks = {"subsets": (got["subsets"], 0.0)}
    checks.update({k: (got[k], lim) for k, lim in limits.items()})
    return checks


def still_leaves(grad1: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is under 1e-3 of their model's median leaf's."""
    out = []
    for side in ("G.", "D."):
        norms = sorted(v for k, v in grad1.items() if k.startswith(side))
        median = norms[len(norms) // 2]
        out += [k for k, v in grad1.items() if k.startswith(side) and v < 1e-3 * median]
    return out


def by_model(fn, prog, ref, leave_out=(), name: bool = False):
    """fn over G's leaves and over D's apart, each against its own model's
    median leaf: the (gap, leaf) of each, or with `name` False the larger
    gap."""
    each = [fn({k: v for k, v in prog.items() if k.startswith(s)},
               {k: v for k, v in ref.items() if k.startswith(s)}, leave_out)
            for s in ("G.", "D.")]
    return each if name else max(g for g, _ in each)


def check(cell, x, mask, wg, wd, seed, device, side: Readings, flops: bool = False):
    """(every number, the operations of one step or None): the reference
    follows `side`'s first step and runs the checked steps."""
    followed = follow_first_step(cell, x, mask, wg, wd, seed, device, side)
    program.free(device)
    ref, counted = reference_first_steps(cell, x, mask, wg, wd, seed, device,
                                         cell.traffic["checked_steps"], flops=flops)
    return numbers(side, ref, followed, stage_plan(cell.config)[2]), counted, followed


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> harness.Window:
    tr = cell.traffic
    n_first, n_checked = tr["first_steps"], tr["checked_steps"]
    x, mask, wg, wd = make_inputs(cell, seed, device)
    state, step = build_step(cell, wg, wd, seed, device)
    prog = program_first_steps(cell, state, step, x, mask, wg, wd, n_first, n_checked)
    _sync(device)
    setup_s = time.perf_counter() - t0

    times, failed, i = [], 0, n_first
    tracer = harness.Trace() if trace else contextlib.nullcontext()
    with tracer:
        start = time.perf_counter()
        while True:
            j = i % tr["pool"]
            t = time.perf_counter()
            state, metrics = step(state, x[j], mask[j])
            m = read_metrics(metrics)
            times.append(time.perf_counter() - t)
            failed += not all(v == v and abs(v) != float("inf") for v in m.values())
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    del state, step, metrics
    program.free(device)
    t = time.perf_counter()
    got, flops, _ = check(cell, x, mask, wg, wd, seed, device, prog, flops=trace)
    check_s = time.perf_counter() - t
    return harness.Window(units=len(times), window_s=window_s, setup_s=setup_s,
                          unit_times=times, memory_peak_bytes=peak,
                          checks=compare(got, cell.limits), attempted=len(times), failed=failed,
                          trace=tracer if trace else None, flops_per_unit=flops,
                          notes={"readings": got, "check_s": check_s})
