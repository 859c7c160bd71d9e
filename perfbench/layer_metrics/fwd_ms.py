"""Device ms per step launched by the train step's forwards: the union of
the device operations launched under the program spans `train.g_forward`
(both G forwards, the loss terms, D in G's objective) and `train.d_forward`
(D on the fake and the real pair), with their descendants
(perfbench/spans.py). The span names are part of the benchmark's contract:
a program that renames or removes them reads None until a `benchmark`
change follows it."""
from perfbench import spans

SPANS = ("train.g_forward", "train.d_forward")


def read(ctx):
    return spans.read(ctx, SPANS)
