"""Device ms per step launched by the optimizers: the union of the device
operations launched under the program spans `train.g_adam` (the freeze
mask, G's Adam step, the frozen leaves put back) and `train.d_adam` (D's
Adam step), with their descendants (perfbench/spans.py). The span names are
part of the benchmark's contract: a program that renames or removes them
reads None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("train.g_adam", "train.d_adam")


def read(ctx):
    return spans.read(ctx, SPANS)
