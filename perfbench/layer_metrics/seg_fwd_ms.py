"""Device ms per step launched under the program span `segtrain.forward`:
the segmentation net's forward in the deep-supervised SGD step
(engine/seg_train.py), the ViL mixers' forwards among it
(perfbench/spans.py, with `segtrain.forward` among the spans attributed).
The span name is part of the benchmark's contract: a program that renames
or removes it reads None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("segtrain.forward",)


def read(ctx):
    return spans.read(ctx, SPANS)
