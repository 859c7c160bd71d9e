"""Device ms per step launched under the program span `segtrain.backward`:
the deep-supervised SGD step's backward, the ViL mixers' backwards (the
mLSTM states and backward kernels) among it; the autograd engine's kernels
count where the step's thread waited for them (engine/seg_train.py,
perfbench/spans.py, with `segtrain.backward` among the spans attributed).
The span name is part of the benchmark's contract: a program that renames
or removes it reads None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("segtrain.backward",)


def read(ctx):
    return spans.read(ctx, SPANS)
