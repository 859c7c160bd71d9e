"""Device idle ms per step that began while the step's thread was inside
the program spans `train.g_backward` or `train.d_backward`
(perfbench/spans.py): the time the backwards kept the device waiting. The
span names are part of the benchmark's contract: a program that renames or
removes them reads None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("train.g_backward", "train.d_backward")


def read(ctx):
    return spans.read(ctx, SPANS, "idle_ms")
