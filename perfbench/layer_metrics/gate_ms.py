"""Device ms per unit of work (a step, a sweep) launched under the program
span `rsm.gate`: the RSM gates of the seg decoder's AttenModule2 joins, the
weight fold and the thin 7^3 conv of each (nn/blocks.py
`_composed_pool_gate`; in a train step the forwards', their backward runs
under the step's backward span). The span name is part of the benchmark's
contract: a program that renames or removes it reads None until a
`benchmark` change follows it.

`perfbench/spans.py` reads the spans it names; this reader adds `rsm.gate`
to them and attributes the window the same way (`spans.attribute`)."""
from __future__ import annotations

import functools

from perfbench import spans

SPANS = ("rsm.gate",)


@functools.lru_cache(maxsize=1)
def table(trace, units: int):
    """`spans.attribute` over the window, with the `SPANS` opened on the
    host among the program spans."""
    import torch

    annotations, launches, ops = spans.events(trace)
    cuda = torch.autograd.DeviceType.CUDA
    for e in trace.prof.profiler.kineto_results.events():
        if e.name() in SPANS and e.device_type() != cuda:
            s = e.start_ns()
            annotations.append((e.name(), s, s + e.duration_ns(), e.start_thread_id()))
    return spans.attribute(annotations, launches, ops, trace.window, units)


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    found = table(ctx.trace, ctx.units)
    if not any(n in found for n in SPANS):
        return None
    return sum(found[n]["busy_ms"] for n in SPANS if n in found)
