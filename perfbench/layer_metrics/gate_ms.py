"""Device ms per unit of work (a step, a sweep) launched under the program
span `rsm.gate`: the RSM gates of the seg decoder's AttenModule2 joins, the
weight fold and the thin 7^3 conv of each (nn/blocks.py
`_composed_pool_gate`; in a train step the forwards', their backward runs
under the step's backward span) (perfbench/spans.py, with `rsm.gate` among
the spans attributed). The span name is part of the benchmark's contract:
a program that renames or removes it reads None until a `benchmark` change
follows it."""
from __future__ import annotations

import functools

from perfbench import spans

SPANS = ("rsm.gate",)


@functools.lru_cache(maxsize=1)
def table(trace, units: int):
    """The window's whole attribution, `SPANS` among its spans."""
    return spans.table(trace, units, *SPANS)


def read(ctx):
    return spans.read(ctx, SPANS)
