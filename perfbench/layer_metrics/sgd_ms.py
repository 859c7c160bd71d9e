"""Device ms per step launched under the program span `segtrain.sgd`: the
deep-supervised SGD step's gradient clip and its Nesterov SGD update, with
their descendants (engine/seg_train.py, perfbench/spans.py). The span name
is part of the benchmark's contract: a program that renames or removes it
reads None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("segtrain.sgd",)


def read(ctx):
    return spans.read(ctx, SPANS)
