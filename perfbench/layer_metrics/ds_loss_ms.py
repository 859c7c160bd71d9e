"""Device ms per step launched under the program span `segtrain.loss`: the
deep-supervised DC + BCE loss over the heads (engine/seg_train.py)
(perfbench/spans.py, with `segtrain.loss` among the spans attributed). The
span name is part of the benchmark's contract: a program that renames or
removes it reads None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("segtrain.loss",)


def read(ctx):
    return spans.read(ctx, SPANS)
