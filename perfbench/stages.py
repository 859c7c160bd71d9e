"""Following the program stage by stage from its own values.

At the end of these random-weight nets a bf16 program lies far from the
fp32 answer, and so does an fp8 one: each InstanceNorm renormalises the
rounding of a channel whose mean is several times its spread, the error
compounds from stage to stage, and both saturate alike (PERF.md §2). So
the check also follows the program one stage at a time:

- `Recorder` keeps the output of every call of the program's stages (its
  submodules, by the names they share with the reference), tagged with a
  phase: which forward of the training step, which subset of the sweep,
  or the sweep's hoisted prefix;
- `Follower` runs the reference's own forward with hooks on the same
  stages: at a call the program recorded, it measures how far the
  program's output lies from the reference's and hands the program's on
  (teacher forcing), so that each stage's gap is that stage's own rounding
  and not the sum of all before it.

The glue between the stages (products of experts, sampling, joins,
residual adds, heads, losses) is the reference's, computed from the
program's values: a fault there shows at the next stage or at the outputs.
A stage the program never calls through its module is computed by the
reference itself and not compared; a phase with no stage recorded reads
NaN, which is never correct.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import torch
from torch import nn


def stage_names(model: nn.Module, island: type) -> List[str]:
    """The stages of a reference model: its children, and inside a child
    that holds a module of type `island` (the ViL), that child's children,
    down to the island itself, so that no stage holds another."""
    out: List[str] = []

    def walk(module, prefix):
        for name, child in module.named_children():
            full = prefix + name
            if isinstance(child, island) or not any(isinstance(m, island)
                                                    for m in child.modules()):
                out.append(full)
            else:
                walk(child, full + ".")

    walk(model, "")
    return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _leaves(item)]
    return []


def _rebuild(like, leaves: List[torch.Tensor]):
    """`leaves` in the structure of `like` (tensors, tuples, named tuples)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return node

    return build(like)


def rel_l2(out: torch.Tensor, ref: torch.Tensor, base: Optional[torch.Tensor] = None) -> float:
    """||out - ref|| / ||ref - base|| (base 0 when None), in float64."""
    d = out.double().to(ref.device) - ref.double()
    scale = ref.double() - (0.0 if base is None else base.double())
    return float(d.norm() / scale.norm().clamp(min=1e-30))


class Recorder:
    """Forward hooks on the named submodules of `model`: each call's output
    leaves, detached copies on `store` (None: where they are), kept under
    (name, phase), and for the stages in `inputs` its input leaves too,
    under ("in", name, phase). The phase of each forward of `model` itself
    is `phase_of(kwargs, count)`, count the forwards before it; None
    records nothing in that forward."""

    def __init__(self, model: nn.Module, names: Sequence[str],
                 phase_of: Callable[[dict, int], Optional[Hashable]], store=None,
                 inputs: Sequence[str] = ()):
        self.records: Dict[tuple, List[List[torch.Tensor]]] = {}
        self.phase: Optional[Hashable] = None
        self.count = 0
        self.store = store
        self.phase_of = phase_of
        self.inputs = set(inputs)
        self.hooks = [model.register_forward_pre_hook(self._enter, with_kwargs=True)]
        for name in names:
            module = model if name == "" else model.get_submodule(name)
            self.hooks.append(module.register_forward_hook(functools.partial(self._keep, name)))

    def _enter(self, module, args, kwargs):
        self.phase = self.phase_of(kwargs, self.count)
        self.count += 1

    def _copy(self, tree) -> List[torch.Tensor]:
        return [t.detach().to(self.store or t.device, copy=True) for t in _leaves(tree)]

    def _keep(self, name, module, args, out):
        if self.phase is None:
            return
        self.records.setdefault((name, self.phase), []).append(self._copy(out))
        if name in self.inputs:
            self.records.setdefault(("in", name, self.phase), []).append(self._copy(args))

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks = []


class Follower:
    """Forward hooks on the named stages of a reference model. At the k-th
    call of a stage in phase `phase`, where the records hold that call: the
    gap of the recorded output to the reference's, rounded to the recorded
    dtype (each leaf's relative L2 distance, the worst over the leaves; for
    a stage in `residual`, which also starts from the program's recorded
    input, against the stage's own change, output less input), then the
    recorded output in the reference's place. Where only the `fallback`
    phase holds the call (the sweep's prefix, computed once for every
    subset), its output is handed on without a gap. The caller sets the phase before each forward
    (`start`), or `phase_of` sets it as the Recorder does."""

    def __init__(self, model: nn.Module, names: Sequence[str], records: Dict[tuple, list],
                 residual: Sequence[str] = (),
                 phase_of: Optional[Callable[[dict, int], Optional[Hashable]]] = None):
        self.records, self.residual = records, set(residual)
        self.phase: Optional[Hashable] = None
        self.fallback: Optional[Hashable] = None
        self.gaps: Dict[str, float] = {}
        self.seen: Dict[tuple, int] = {}
        self.hooks = []
        if phase_of is not None:
            # the phase of each forward of the model, as the Recorder tags it
            count = iter(range(1 << 62))
            self.hooks.append(model.register_forward_pre_hook(
                lambda m, a, kw: setattr(self, "phase", phase_of(kw, next(count))),
                with_kwargs=True))
        for name in names:
            module = model if name == "" else model.get_submodule(name)
            self.hooks.append(module.register_forward_hook(functools.partial(self._force, name)))
            if name in self.residual:
                self.hooks.append(module.register_forward_pre_hook(
                    functools.partial(self._force_input, name)))

    def start(self, phase: Hashable, fallback: Optional[Hashable] = None) -> None:
        """The phase of the next forward, and its fallback; each recorded
        call is taken afresh from the first."""
        self.phase, self.fallback, self.seen = phase, fallback, {}

    def _take(self, key):
        calls = self.records.get(key)
        k = self.seen.get(key, 0)
        if calls is None or k >= len(calls):
            return None
        self.seen[key] = k + 1
        return calls[k]

    def _note(self, name, gap):
        if not gap <= self.gaps.get(name, -1.0):
            self.gaps[name] = gap

    def _force_input(self, name, module, args):
        """A residual stage (the ViL) starts from the program's own input:
        its gap is then the stage's alone, and the input's gap to the
        reference's glue is noted as `<name>.in`."""
        kept = self._take(("in", name, self.phase))
        if kept is None:
            return None
        mine = _leaves(args)
        self._note(f"{name}.in", max(rel_l2(p, r) for p, r in zip(kept, mine)))
        return _rebuild(args, [p.to(r.device, r.dtype) for p, r in zip(kept, mine)])

    def _force(self, name, module, args, out):
        mine = _leaves(out)
        kept = self._take((name, self.phase))
        compare = kept is not None
        if kept is None and self.fallback is not None:
            kept = self._take((name, self.fallback))
        if kept is None:
            return None
        if len(kept) != len(mine):
            raise ValueError(f"stage {name}: the program gave {len(kept)} tensors, "
                             f"the reference {len(mine)}")
        if compare:
            base = _leaves(args)[0] if name in self.residual else None
            # the reference's output as the program's dtype holds it: a stage
            # that returns bf16 is not charged for that last rounding
            self._note(name, max(rel_l2(p, r.to(p.dtype), base) for p, r in zip(kept, mine)))
        return _rebuild(out, [p.to(r.device, r.dtype) for p, r in zip(kept, mine)])

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks = []


def worst(gaps: Dict[str, float], names: Sequence[str]) -> float:
    """The largest gap of the named stages; NaN where none was measured."""
    seen = [gaps[n] for n in names if n in gaps]
    if not seen:
        return math.nan
    return max(seen, key=lambda v: math.inf if v != v else v)
