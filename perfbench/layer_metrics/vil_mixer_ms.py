"""Device ms per step launched under the program span `vil.mixer`: the
forwards of the UxLSTM nets' ViL mixers (models/uxlstm.py
`ViLMixerND.forward`: the fp32 cast, the ViL block with its mLSTM kernels,
the cast back); their backward counts under the step's backward span
(perfbench/spans.py, with `vil.mixer` among the spans attributed). The span
name is part of the benchmark's contract: a program that renames or removes
it reads None until a `benchmark` change follows it."""
from perfbench import spans

SPANS = ("vil.mixer",)


def read(ctx):
    return spans.read(ctx, SPANS)
