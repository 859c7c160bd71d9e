"""Device ms per unit of work (a step, a sweep) launched under the program
span `vil.conv1d`: the ViL's depthwise causal conv (nn/vil.py
`CausalConv1d.forward`; in a train step the forward's, its backward runs
under the step's backward span) (perfbench/spans.py). The span name is part
of the benchmark's contract: a program that renames or removes it reads
None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("vil.conv1d",)


def read(ctx):
    return spans.read(ctx, SPANS)
