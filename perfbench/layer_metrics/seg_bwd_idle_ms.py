"""Device idle ms per step that began while the step's thread was inside
the program span `segtrain.backward` (engine/seg_train.py,
perfbench/spans.py): the time the deep-supervised SGD step's backward kept
the device waiting. The span name is part of the benchmark's contract: a
program that renames or removes it reads None until a `benchmark` change
follows it."""
from perfbench import spans

SPANS = ("segtrain.backward",)


def read(ctx):
    return spans.read(ctx, SPANS, "idle_ms")
