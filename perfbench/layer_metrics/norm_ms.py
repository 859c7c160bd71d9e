"""Device ms per step launched under the program span `uxlstm.norm`: the
forwards of the UxLSTM nets' fused instance norms (models/uxlstm.py
`InstanceNormND.forward`, twice in each `ResBlockND`: the statistics, the
affine, the residual add and LeakyReLU; on the card the kernel
`csrc/instance_norm.cu`); their backward counts under the step's backward
span (perfbench/spans.py, with `uxlstm.norm` among the spans attributed).
The span name is part of the benchmark's contract: a program without it
(one older than the fused norm) reads None, and the line leaves the metric
out."""
from perfbench import spans

SPANS = ("uxlstm.norm",)


def read(ctx):
    return spans.read(ctx, SPANS)
