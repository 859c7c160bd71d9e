"""`perfbench/layer_metrics/norm_ms.py` on hand-built timelines: the device
time launched under the program span `uxlstm.norm` (the UxLSTM nets' fused
instance norms), read as `vil_mixer_ms` reads `vil.mixer`; and None from a
program without the span.

    python -m pytest -q perfbench/tests/test_perfbench_norm_ms.py
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from perfbench.layer_metrics import norm_ms, seg_bwd_ms, seg_fwd_ms, vil_mixer_ms  # noqa: E402
from test_perfbench_gate_ms import Event, Trace, kernel, launch  # noqa: E402

# one step of the timeline: its spans, (name, start, end) in ms; two norms
# in the forward, a ViL mixer between them, none in the backward (the norms'
# backward runs under it)
STEP = [("segtrain.step", 0, 10), ("segtrain.forward", 0.2, 4), ("uxlstm.norm", 0.5, 1.0),
        ("vil.mixer", 1, 2), ("uxlstm.norm", 2.5, 3.0), ("segtrain.loss", 4, 5),
        ("segtrain.backward", 5, 9), ("segtrain.sgd", 9, 10)]


def test_norm_ms_reads_the_forwards_norms():
    """Two steps: a kernel in each norm (0.2 and 0.3 ms), one in the mixer,
    one in the forward outside both, two in the backward; norm_ms gives the
    norms' device ms per step, and the forward counts them too."""
    events = [Event(n, s + off, e + off) for off in (0, 10) for n, s, e in STEP]
    corr = 0
    for off in (0, 10):
        for at, start, end in ((0.6, 0.7, 0.9), (1.5, 1.6, 1.9), (2.6, 2.7, 3.0),
                               (3.2, 3.3, 3.5), (5.5, 5.6, 6.6), (7.5, 7.6, 8.0)):
            corr += 1
            events += [launch(corr, at + off), kernel(corr, start + off, end + off)]
    ctx = SimpleNamespace(trace=Trace(events), units=2)
    ns = 1e-5  # the hand-built times are whole nanoseconds
    assert norm_ms.read(ctx) == pytest.approx(0.2 + 0.3, abs=ns)
    assert vil_mixer_ms.read(ctx) == pytest.approx(0.3, abs=ns)
    assert seg_fwd_ms.read(ctx) == pytest.approx(0.2 + 0.3 + 0.3 + 0.2, abs=ns)
    assert seg_bwd_ms.read(ctx) == pytest.approx(1.0 + 0.4, abs=ns)


def test_a_program_without_the_span_reads_none():
    """A program older than the fused norm (this metric's parent) reads
    None, and so does a run without a trace."""
    events = [Event(n, s, e) for n, s, e in STEP if n != "uxlstm.norm"]
    events += [launch(1, 0.6), kernel(1, 0.7, 0.9)]
    assert norm_ms.read(SimpleNamespace(trace=Trace(events), units=1)) is None
    assert norm_ms.read(SimpleNamespace(trace=None, units=1)) is None
