"""Device time and idle time by program span, from the traced window.

The program opens named ranges on its hot path (`xlstm_hved_torch.utils.
logging.span`), which a recording profiler keeps as host annotations on the
clock of the device trace. `attribute` turns them, the CUDA runtime's launch
calls and the device operations into, for each span name, the device time
the span launched, the idle time it held and the launches it made:

- a device operation belongs to the innermost program span open on the
  step's thread when its launch call began: operation and launch call are
  matched by correlation id, launch call and span by host time, from any
  thread (the backward's kernels are launched from autograd's device
  thread while the step's thread sits inside the backward's span);
- each idle gap of the device (the window less the union of its
  operations) goes to the innermost program span open on the step's thread
  when the gap began.

Sums are inclusive: a span counts what its descendants count.

The span names read (`SPANS`) are the program's, and part of the
benchmark's contract: `train.step`, `train.g_forward`, `train.g_backward`,
`train.g_adam`, `train.d_forward`, `train.d_backward`, `train.d_adam`
(engine/train.py), `sweep.prefix`, `sweep.suffix` (engine/evaluate.py) and
`vil.conv1d` (nn/vil.py). A program that renames or removes one leaves the
metrics that read it at None, out of the line, until a `benchmark` change
follows it; a program with none of them (one older than its spans) gives
None everywhere.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

SPANS = ("train.step", "train.g_forward", "train.g_backward", "train.g_adam",
         "train.d_forward", "train.d_backward", "train.d_adam",
         "sweep.prefix", "sweep.suffix", "vil.conv1d")
# device operations that are not kernel launches (as layer_metrics/launches.py)
NOT_KERNELS = ("Memcpy", "Memset")


def _innermost(spans: List[Tuple[int, int, int]], times: Sequence[int]) -> List[int]:
    """For each of `times`, the index into `spans` ((start, end, index),
    sorted by start, properly nested) of the innermost span with start <=
    t < end, or -1."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [-1] * len(times)
    stack: List[Tuple[int, int, int]] = []
    i = 0
    for q in order:
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[q] = stack[-1][2] if stack else -1
    return out


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def attribute(annotations: Sequence[Tuple[str, int, int, int]],
              launches: Sequence[Tuple[int, int]],
              ops: Sequence[Tuple[str, int, int, int]],
              window: Tuple[int, int], units: int) -> Dict[Optional[str], Dict[str, float]]:
    """Per unit of work, for each span name (None: outside every span):
    {"busy_ms": the union of its operations' intervals, "idle_ms", "launches":
    its kernels (copies and sets left out), "calls": how often it opened}.

    annotations: the program spans, (name, start_ns, end_ns, thread); the
      step's thread is the one that opened the most, the others are left out.
    launches: the launch calls, (correlation id, start_ns).
    ops: the device operations in the window, (name, start_ns, end_ns,
      correlation id); one whose launch call is missing counts as launched
      outside every span.
    window: (start_ns, end_ns) of the traced window; idle is measured in it.
    """
    counts: Dict[int, int] = {}
    for a in annotations:
        counts[a[3]] = counts.get(a[3], 0) + 1
    thread = max(counts, key=counts.get) if counts else None
    # (start, end, name), a parent before a child that starts with it
    mine = sorted(((a[1], a[2], a[0]) for a in annotations if a[3] == thread),
                  key=lambda a: (a[0], -a[1]))
    # each span's names, itself and its ancestors, once each
    chains: List[Tuple[str, ...]] = []
    stack: List[int] = []
    for s, e, name in mine:
        while stack and mine[stack[-1]][1] <= s:
            stack.pop()
        up = chains[stack[-1]] if stack else ()
        chains.append(tuple(dict.fromkeys((name,) + up)))
        stack.append(len(chains) - 1)
    spans = [(s, e, i) for i, (s, e, _) in enumerate(mine)]

    def owners(times: Sequence[int]) -> List[Tuple[Optional[str], ...]]:
        return [chains[k] if k >= 0 else (None,) for k in _innermost(spans, times)]

    launched = dict(launches)
    hit = [i for i, o in enumerate(ops) if o[3] in launched]
    chain_of: List[Tuple[Optional[str], ...]] = [(None,)] * len(ops)
    for i, chain in zip(hit, owners([launched[ops[i][3]] for i in hit])):
        chain_of[i] = chain
    busy: Dict[Optional[str], List[Tuple[int, int]]] = {}
    kernels: Dict[Optional[str], int] = {}
    for (name, s, e, _), chain in zip(ops, chain_of):
        for n in chain:
            busy.setdefault(n, []).append((s, e))
            if not name.startswith(NOT_KERNELS):
                kernels[n] = kernels.get(n, 0) + 1

    # idle gaps: the window less the union of every operation
    lo, hi = window
    gaps, end = [], lo
    for s, e in sorted((o[1], o[2]) for o in ops):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    idle: Dict[Optional[str], int] = {}
    for (s, e), chain in zip(gaps, owners([g[0] for g in gaps])):
        for n in chain:
            idle[n] = idle.get(n, 0) + e - s

    calls: Dict[Optional[str], int] = {}
    for _, _, n in mine:
        calls[n] = calls.get(n, 0) + 1
    out: Dict[Optional[str], Dict[str, float]] = {}
    for n in set(busy) | set(idle) | set(calls):
        out[n] = {"busy_ms": _union_ns(busy.get(n, [])) * 1e-6 / units,
                  "idle_ms": idle.get(n, 0) * 1e-6 / units,
                  "launches": kernels.get(n, 0) / units,
                  "calls": calls.get(n, 0) / units}
    return out


def events(trace) -> Tuple[list, list, list]:
    """(annotations, launches, ops) of a harness.Trace's window, from its
    profiler's events: the program spans (`SPANS`) opened on the host, the
    runtime's launch calls (host events named cu*), and the device
    operations as `Trace.kernels` has them (device-side annotations and the
    window's own range left out)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    lo, hi = trace.window
    wanted = set(SPANS)
    annotations, launches, ops = [], [], []
    for e in trace.prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and name != trace.MARK:
                s = e.start_ns()
                end = s + e.duration_ns()
                if lo <= s and end <= hi:
                    ops.append((name, s, end, e.correlation_id()))
        elif name in wanted:
            s = e.start_ns()
            annotations.append((name, s, s + e.duration_ns(), e.start_thread_id()))
        elif name.startswith("cu"):
            launches.append((e.correlation_id(), e.start_ns()))
    return annotations, launches, ops


@functools.lru_cache(maxsize=1)
def table(trace, units: int) -> Dict[Optional[str], Dict[str, float]]:
    """`attribute` over a harness.Trace's window (kept for the window's
    readers, which all read the one table)."""
    return attribute(*events(trace), trace.window, units)


def read(ctx, names: Sequence[str], field: str = "busy_ms") -> Optional[float]:
    """The sum of `field` per unit over the spans `names`, or None without a
    trace, a unit, or any of the spans in the window."""
    if ctx.trace is None or not ctx.units:
        return None
    found = table(ctx.trace, ctx.units)
    if not any(n in found for n in names):
        return None
    return sum(found[n][field] for n in names if n in found)
