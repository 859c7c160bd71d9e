"""Device ms per sweep launched under the program span `sweep.suffix`: each
subset's mask, suffix forward and accumulation, 15 per window
(engine/evaluate.py) (perfbench/spans.py). The span name is part of the
benchmark's contract: a program that renames or removes it reads None until
a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("sweep.suffix",)


def read(ctx):
    return spans.read(ctx, SPANS)
