"""The deep-supervised SGD step of nnU-Net's trainer on a segmentation net
(`engine/seg_train.py`), in a closed loop.

Set-up makes a pool of synthetic volumes on the device with their region
targets at every head's scale, the net's weights from the seed (the
configuration's builder), the program's step (`make_sgd`,
`make_ds_train_step`), and drives it through its first steps on distinct
batches: the warm-up, and the steps the reference follows. In the first
step a `stages.Recorder` keeps, on the host, the output of every stage of
the net (the encoder's stages and mixers, the ViL mixers' inputs too, the
decoder's up-convs, blocks and heads); the first `checked_steps` leave each
leaf's change. The window then runs the same step on the pool in turn,
each step's loss read back as nnU-Net's trainer reads it
(`loss.detach().cpu()`). In the first step's
backward a `ViLBackward` keeps, for each ViL mixer, the cotangent its output
received, the one it handed its input and each of its parameters'
gradient. After the window the program is freed and the plain reference
(`reference/uxlstm.py`), in fp32 with TF32 off, follows the first step
stage by stage from the program's own values, computes the deep-supervised
loss from the program's heads, runs each ViL mixer's backward from the
program's own input and cotangent, and runs the checked steps from the same
weights and batches.

Traffic parameters: "patch" (D, H, W: the plan's patch), "batch", "pool"
(batches made), "first_steps" (warm-up steps), "checked_steps" (the first of
them the reference follows), "steps_per_epoch" (the poly schedule's epoch).
"""
from __future__ import annotations

import contextlib
import copy
import functools
import math
import time
from typing import Dict, List

import torch

from perfbench import harness, stages, synthetic
from perfbench.drivers import program
from perfbench.drivers.train_step import _change, _sync
from perfbench.reference import uxlstm as ref_uxlstm
from perfbench.reference.precision import strict_fp32


class Readings:
    """What the first steps leave, on either side: each step's loss, the
    first gradient's leaf norms (the reference's), each leaf's change, the
    first step's stage outputs (`stages.Recorder`) and its ViL mixers'
    gradients (`ViLBackward`)."""

    def __init__(self):
        self.losses: List[float] = []
        self.grad1: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.records: Dict[tuple, list] = {}
        self.vil_dy: Dict[str, torch.Tensor] = {}
        self.vil_dx: Dict[str, torch.Tensor] = {}
        self.vil_grads: Dict[str, torch.Tensor] = {}


class ViLBackward:
    """Hooks on the named ViL mixers of `net` for its next backward, copied
    to the host: the cotangent each mixer's output receives (`dy`), the one
    it hands its input alone (`dx`, through an alias of the input that only
    the mixer reads) and each of its parameters' gradient (`grads`, by the
    parameter's name in `net`, before any clip). `remove` after the first
    backward: the tensors' hooks end with that step's graph."""

    def __init__(self, net, mixers):
        self.dy: Dict[str, torch.Tensor] = {}
        self.dx: Dict[str, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        self.hooks = []
        for name in mixers:
            mixer = net.get_submodule(name)
            self.hooks.append(mixer.register_forward_pre_hook(functools.partial(self._enter, name)))
            self.hooks.append(mixer.register_forward_hook(functools.partial(self._leave, name)))
            for leaf, p in mixer.named_parameters():
                self.hooks.append(p.register_hook(
                    functools.partial(self._keep, self.grads, f"{name}.{leaf}")))

    @staticmethod
    def _keep(store, key, g):
        store[key] = g.detach().to("cpu", copy=True)

    def _enter(self, name, module, args):
        x = args[0].view_as(args[0])
        if x.requires_grad:
            x.register_hook(functools.partial(self._keep, self.dx, name))
        return (x,) + tuple(args[1:])

    def _leave(self, name, module, args, out):
        if out.requires_grad:
            out.register_hook(functools.partial(self._keep, self.dy, name))

    def keep(self, readings: Readings) -> None:
        readings.vil_dy, readings.vil_dx, readings.vil_grads = self.dy, self.dx, self.grads

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks = []


def make_inputs(cell, seed: int, device):
    """(x (pool, batch, C, *patch), targets: per batch of the pool, the
    region masks at each head's scale, the weights)."""
    tr, model = cell.traffic, cell.config["model"]
    if list(tr["patch"]) != list(model["patch_size"]):
        raise ValueError(f"the traffic's patch {tr['patch']} is not the plan's "
                         f"{model['patch_size']}")
    gen = torch.Generator(device=device).manual_seed(seed)
    x, mask = synthetic.pool(gen, tr["pool"] * tr["batch"], tr["patch"])
    x = x.view((tr["pool"], tr["batch"]) + tuple(x.shape[1:]))
    mask = mask.view((tr["pool"], tr["batch"]) + tuple(mask.shape[1:]))
    scales = ref_uxlstm.ds_scales(model["pool_op_kernel_sizes"])
    targets = [[t.contiguous() for t in ref_uxlstm.ds_targets(mask[j], scales)]
               for j in range(tr["pool"])]
    return x, targets, harness.builder(cell.config).make_weights(model, gen)


def _train(cell) -> dict:
    return dict(cell.config["train"], steps_per_epoch=cell.traffic["steps_per_epoch"])


def build_step(cell, weights, device):
    from xlstm_hved_torch.engine import seg_train

    net = harness.builder(cell.config).build_program(cell.config["model"], weights, device)
    cfg = seg_train.SegTrainConfig(**_train(cell))
    state = seg_train.SegTrainState(net, seg_train.make_sgd(net.parameters(), cfg))
    return state, seg_train.make_ds_train_step(net, cfg)


def stage_plan(config: dict):
    """(every stage by name, the ViL mixers among them), from the
    reference's module tree: the encoder's children, then the decoder's."""
    ref = harness.builder(config).reference_module(config["model"], "meta")
    names = [f"{part}.{n}" for part in ("encoder", "decoder")
             for n, _ in ref.get_submodule(part).named_children()]
    vil = [n for n in names if isinstance(ref.get_submodule(n), ref_uxlstm.ViLMixer)]
    return names, vil


def _first(kwargs, count):
    return 0 if count == 0 else None  # the first step's forward


def recorder(config: dict, net) -> stages.Recorder:
    names, vil = stage_plan(config)
    return stages.Recorder(net, names, _first, torch.device("cpu"), inputs=vil)


def program_first_steps(cell, state, step, x, targets, weights, n: int,
                        checked: int) -> Readings:
    """Run n steps on the pool's first n batches; the readings of the first
    `checked` (the change as step `checked` left it)."""
    r = Readings()
    rec = recorder(cell.config, state.model)
    back = ViLBackward(state.model, stage_plan(cell.config)[1])
    for i in range(n):
        state, loss = step(state, x[i], targets[i])
        r.losses.append(float(loss))
        if i == 0:
            rec.remove()
            back.remove()
            r.records = rec.records
            back.keep(r)
        if i == checked - 1:
            r.change = _change(state.model, weights)
    r.losses = r.losses[:checked]
    return r


def reference_first_steps(cell, x, targets, weights, device, n: int, precision: str = "float32",
                          flops: bool = False, record: bool = False):
    """The reference's Readings over the first n steps (with `record`, its
    first step's stages kept as the program's are: the control in the
    program's place), and with `flops` the operations its first step
    counted (forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with strict_fp32():
        net = harness.builder(cell.config).build_reference(cell.config["model"], weights,
                                                           device, precision)
        ref = ref_uxlstm.Step(net, _train(cell))
        r = Readings()
        rec = recorder(cell.config, net) if record else None
        back = ViLBackward(net, stage_plan(cell.config)[1]) if record else None
        counted = None
        for i in range(n):
            if flops and i == 0:
                counter = FlopCounterMode(display=False)
                with counter:
                    r.losses.append(ref(x[i], targets[i]))
                counted = float(counter.get_total_flops())
            else:
                r.losses.append(ref(x[i], targets[i]))
            if i == 0:
                r.grad1 = dict(ref.grad1)
                if rec is not None:
                    rec.remove()
                    back.remove()
                    r.records = rec.records
                    back.keep(r)
        r.change = _change(net, weights)
    del net, ref
    return r, counted


def follow_first_step(cell, x, targets, weights, device, side: Readings) -> Dict[str, float]:
    """The reference's first forward followed stage by stage from `side`'s
    recorded values (`stages.Follower`): each stage's gap, by name, and
    "loss", the relative gap of the side's first loss to the reference's
    deep-supervised loss of the side's own heads."""
    names, vil = stage_plan(cell.config)
    with strict_fp32(), torch.no_grad():
        net = harness.builder(cell.config).build_reference(cell.config["model"], weights, device)
        follow = stages.Follower(net, names, side.records, vil, _first)
        loss = float(ref_uxlstm.ds_loss(net(x[0]), targets[0]))
        follow.remove()
    del net
    gaps = dict(follow.gaps)
    gaps["loss"] = harness.rel_gap(side.losses[0], loss)
    return gaps


def follow_vil_backward(cell, weights, device, side: Readings) -> Dict[str, float]:
    """Each ViL mixer's backward in the reference, from `side`'s own input
    to the mixer and the cotangent its output received in the first step:
    the gap of each of the side's gradients of the mixer, by name: its
    input's (`<mixer>.dx`, relative L2 to the reference's rounded to the
    side's dtype) and its parameters' (the L2 distance against the larger
    of the leaf's own reference norm and the mixer's median leaf's, as
    `harness.worst_leaf` weighs a change: the input gate's bias takes a
    gradient near 0, since a shift of every input gate leaves the mLSTM's
    normalised output as it was; a gradient the side did not give reads 1
    or less); NaN for a mixer whose input or cotangent the side did not
    keep."""
    _, vil = stage_plan(cell.config)
    gaps: Dict[str, float] = {}
    with strict_fp32():
        net = harness.builder(cell.config).build_reference(cell.config["model"], weights, device)
        for name in vil:
            mixer = net.get_submodule(name)
            leaves = [(f"{name}.{k}", p) for k, p in mixer.named_parameters()]
            kept = side.records.get(("in", name, 0))
            dy, dx = side.vil_dy.get(name), side.vil_dx.get(name)
            if kept is None or dy is None or dx is None:
                gaps.update({k: float("nan") for k, _ in leaves}, **{f"{name}.dx": float("nan")})
                continue
            inp = kept[0][0].to(device, torch.float32).requires_grad_(True)
            grads = torch.autograd.grad(mixer(inp), [inp] + [p for _, p in leaves],
                                        dy.to(device, torch.float32))
            gaps[f"{name}.dx"] = stages.rel_l2(dx, grads[0].to(dx.dtype))
            norms = [float(g.double().norm()) for g in grads[1:]]
            median = sorted(norms)[len(norms) // 2]
            for (k, _), ref, norm in zip(leaves, grads[1:], norms):
                got = side.vil_grads.get(k)
                got = torch.zeros_like(ref) if got is None else got.to(ref.device)
                gaps[k] = float((got.double() - ref.double()).norm()) / max(norm, median, 1e-30)
    del net
    return gaps


def leaves_left_out(config: dict, grad1: Dict[str, float]) -> List[str]:
    """The leaves whose change is rounding or nothing by the net's
    structure: the biases of the convs that feed an instance norm (conv1
    and conv2 of every residual block: the norm takes their gradient away
    with the mean) and the leaves the reference's first gradient does not
    reach (the head of weight 0)."""
    ref = harness.builder(config).reference_module(config["model"], "meta")
    fed = [f"{name}.{conv}.bias" for name, m in ref.named_modules()
           if isinstance(m, ref_uxlstm.ResBlock) for conv in ("conv1", "conv2")]
    return fed + [k for k, v in grad1.items() if v == 0.0]


def change_numbers(config: dict, change: Dict[str, float], ref: Readings) -> Dict:
    """The gaps of each leaf's change over the checked steps, each against
    the larger of its own reference norm and the median leaf's, less
    `leaves_left_out`: change_gap / change_gap_median the worst / the
    median leaf, vil_change_gap the worst of the ViL mixers' leaves;
    change_leaf and vil_change_leaf name the worst."""
    out = set(leaves_left_out(config, ref.grad1))
    vil = tuple(f"{m}." for m in stage_plan(config)[1])
    worst = harness.worst_leaf(change, ref.change, out)
    vil_worst = harness.worst_leaf(change, ref.change,
                                   [k for k in ref.change if k in out or not k.startswith(vil)])
    return {"change_gap": worst[0], "change_leaf": worst[1],
            "change_gap_median": harness.median_leaf(change, ref.change, out)[0],
            "vil_change_gap": vil_worst[0], "vil_change_leaf": vil_worst[1]}


def numbers(config: dict, side: Readings, ref: Readings, followed: Dict[str, float],
            backward: Dict[str, float]) -> Dict:
    """The numbers the checked steps give, a side (the program, or the
    control in its place) against the reference:
    - stage_gap: the worst stage of the first forward (the heads among
      them), followed from the side's own values, the ViL mixers' apart but
      for their input (`<stage>.in`);
    - vil_gap: the worst ViL mixer from the side's own input, against the
      mixer's own change;
    - vil_grad_gap: the worst gradient of the ViL mixers' backward from the
      side's own input and cotangent (`follow_vil_backward`); vil_grad_leaf
      names it;
    - loss_gap: the side's first loss against the reference's loss of the
      side's own heads;
    - the gaps of each leaf's change over the checked steps
      (`change_numbers`)."""
    vil = stage_plan(config)[1]
    plain = [k for k in followed if k != "loss" and k not in vil]
    back = max(backward.items(), key=lambda kv: math.inf if kv[1] != kv[1] else kv[1],
               default=("", math.nan))
    return {
        "stage_gap": stages.worst(followed, plain),
        "vil_gap": stages.worst(followed, list(vil)),
        "vil_grad_gap": back[1],
        "vil_grad_leaf": back[0],
        "loss_gap": followed["loss"],
        **change_numbers(config, side.change, ref),
    }


def compare(got: Dict[str, float], limits: dict):
    """The numbers with a limit in the cell's limits file, each (value, limit)."""
    return {k: (got[k], lim) for k, lim in limits.items()}


def check(cell, x, targets, weights, device, side: Readings, flops: bool = False):
    """(every number, the operations of one step or None, the stage gaps):
    the reference follows `side`'s first step, forward and the ViL mixers'
    backward, and runs the checked steps."""
    followed = follow_first_step(cell, x, targets, weights, device, side)
    backward = follow_vil_backward(cell, weights, device, side)
    program.free(device)
    ref, counted = reference_first_steps(cell, x, targets, weights, device,
                                         cell.traffic["checked_steps"], flops=flops)
    return numbers(cell.config, side, ref, followed, backward), counted, followed


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


# the planted faults of the mLSTM's backward: (which input's gradient, its factor)
MLSTM_FAULTS = {"mlstm_dq": (0, 0.5), "mlstm_df": (4, 0.0)}


@contextlib.contextmanager
def mlstm_fault(kind: str):
    """A fault planted in the mLSTM's backward while the block runs:
    "mlstm_dq" halves the gradient of q, "mlstm_df" zeroes the forget
    gate's. On the card in the fused backward's results
    (`ops/mlstm_cuda.py::mlstm_backward`, the wide kernels' at this cell's
    head widths); on the CPU, whose ViL takes the plain scan, in the same
    gradient where `nn/vil.py` calls the scan."""
    from xlstm_hved_torch.nn import vil as program_vil
    from xlstm_hved_torch.ops import mlstm_cuda

    index, scale = MLSTM_FAULTS[kind]
    fused, scan = mlstm_cuda.mlstm_backward, program_vil.mlstm_chunkwise

    def fused_faulty(*args, **kwargs):
        grads = list(fused(*args, **kwargs))
        grads[index] = grads[index] * scale
        return tuple(grads)

    def scan_faulty(*args, **kwargs):
        args = list(args)
        args[index] = _ScaleGrad.apply(args[index], scale)
        return scan(*args, **kwargs)

    mlstm_cuda.mlstm_backward, program_vil.mlstm_chunkwise = fused_faulty, scan_faulty
    try:
        yield
    finally:
        mlstm_cuda.mlstm_backward, program_vil.mlstm_chunkwise = fused, scan


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> harness.Window:
    from xlstm_hved_torch.engine import seg_train  # noqa: F401  (a program without it stops here)

    tr = cell.traffic
    n_first, n_checked = tr["first_steps"], tr["checked_steps"]
    x, targets, weights = make_inputs(cell, seed, device)
    state, step = build_step(cell, weights, device)
    prog = program_first_steps(cell, state, step, x, targets, weights, n_first, n_checked)
    _sync(device)
    setup_s = time.perf_counter() - t0

    times, failed, i = [], 0, n_first
    tracer = harness.Trace() if trace else contextlib.nullcontext()
    with tracer:
        start = time.perf_counter()
        while True:
            j = i % tr["pool"]
            t = time.perf_counter()
            state, loss = step(state, x[j], targets[j])
            value = float(loss)
            times.append(time.perf_counter() - t)
            failed += not (value == value and abs(value) != float("inf"))
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    del state, step, loss
    program.free(device)
    t = time.perf_counter()
    got, flops, _ = check(cell, x, targets, weights, device, prog, flops=trace)
    check_s = time.perf_counter() - t
    return harness.Window(units=len(times), window_s=window_s, setup_s=setup_s,
                          unit_times=times, memory_peak_bytes=peak,
                          checks=compare(got, cell.limits), attempted=len(times), failed=failed,
                          trace=tracer if trace else None, flops_per_unit=flops,
                          notes={"readings": got, "check_s": check_s})


def calibrate_seed(cell, seed: int, device, emit, control: bool) -> None:
    """The readings of one seed for the cell's limits (perfbench/calibrate.py):
    the program's numbers as a run computes them, without the window, and
    "program_fp32", the program with its convs in fp32 and TF32 off (what
    the configuration's bf16 adds to each gap); with `control` also the
    control's (the reference with its convs in fp8 and its ViL in bf16) and
    the faults': "unchanged" (a step that leaves the state as it was: no run
    needed, its change reads 1), "head_dropped" (the program with the
    1/2-scale head's loss weight 0), "vil_skipped" (the program with its
    first ViL mixer handing its input on), "mlstm_dq" and "mlstm_df" (the
    program with a fault in the mLSTM's backward, `mlstm_fault`), and
    "yardstick" (the reference at the configuration's bf16, its ViL in
    fp32, in the program's place)."""
    from xlstm_hved_torch.engine import seg_train

    n, checked = cell.traffic["first_steps"], cell.traffic["checked_steps"]
    x, targets, weights = make_inputs(cell, seed, device)

    def run_program(fault=None, on=cell):
        state, step = build_step(on, weights, device)
        if fault == "vil_skipped":
            state.model.get_submodule(stage_plan(on.config)[1][0]).forward = lambda t: t
        if fault == "head_dropped":
            kept = seg_train.deep_supervision_weights
            seg_train.deep_supervision_weights = lambda k: [0.0 if i == 1 else w
                                                            for i, w in enumerate(kept(k))]
        planted = mlstm_fault(fault) if fault in MLSTM_FAULTS else contextlib.nullcontext()
        try:
            with planted:
                side = program_first_steps(on, state, step, x, targets, weights, n, checked)
        finally:
            if fault == "head_dropped":
                seg_train.deep_supervision_weights = kept
        del state, step
        program.free(device)
        return side

    def judge(name, side):
        got, _, followed = check(cell, x, targets, weights, device, side)
        top = sorted(followed.items(), key=lambda kv: -kv[1])[:5]
        emit(seed, name, got, top)
        program.free(device)

    judge("program", run_program())
    fp32 = copy.copy(cell)
    fp32.config = dict(cell.config, model=dict(cell.config["model"], compute_dtype="float32"))
    with strict_fp32():
        judge("program_fp32", run_program(on=fp32))
    if not control:
        return
    judge("control", reference_first_steps(cell, x, targets, weights, device, checked,
                                           "float8", record=True)[0])
    emit(seed, "unchanged", {"change_gap": 1.0, "change_gap_median": 1.0}, [])
    for fault in ("head_dropped", "vil_skipped", *MLSTM_FAULTS):
        judge(fault, run_program(fault))
    judge("yardstick", reference_first_steps(cell, x, targets, weights, device, checked,
                                             "bfloat16", record=True)[0])
