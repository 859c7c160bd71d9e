"""Device ms per sweep launched under the program span `sweep.prefix`: the
hoisted sweep's subset-invariant prefix, once per window
(engine/evaluate.py) (perfbench/spans.py). The span name is part of the
benchmark's contract: a program that renames or removes it reads None until
a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("sweep.prefix",)


def read(ctx):
    return spans.read(ctx, SPANS)
