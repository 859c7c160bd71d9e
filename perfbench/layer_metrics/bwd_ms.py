"""Device ms per step launched by the train step's backwards: the union of
the device operations launched under the program spans `train.g_backward`
and `train.d_backward` (the gradients and their average over ranks), with
their descendants; the autograd engine's kernels count where the step's
thread waited for them (perfbench/spans.py). The span names are part of the
benchmark's contract: a program that renames or removes them reads None
until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("train.g_backward", "train.d_backward")


def read(ctx):
    return spans.read(ctx, SPANS)
