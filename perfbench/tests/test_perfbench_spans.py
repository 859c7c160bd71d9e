"""`perfbench/spans.py` on hand-built timelines: device time, idle time and
launches by program span.

    python -m pytest -q perfbench/tests/test_perfbench_spans.py
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import spans

MAIN, AUTOGRAD = 11, 22
MS = 1_000_000  # ns


def ns(t: float) -> int:
    return int(round(t * MS))


def span(name, start, end, thread=MAIN):
    return (name, ns(start), ns(end), thread)


def kernel(corr, start, end, name="kernel"):
    return (name, ns(start), ns(end), corr)


def launch(corr, at):
    return (corr, ns(at))


def test_a_launch_from_another_thread_goes_to_the_span_open_on_the_step_thread():
    """The backward's kernels are launched by autograd's thread while the
    step's thread waits inside the backward span; the kernel runs after the
    span has closed. A span opened on a thread with fewer spans is not the
    step's and is left out."""
    annotations = [span("train.step", 0, 10), span("train.g_backward", 1, 5),
                   span("vil.conv1d", 2, 3, thread=AUTOGRAD)]
    out = spans.attribute(annotations, [launch(7, 2.5)], [kernel(7, 6, 8)], (0, ns(10)), 1)
    assert out["train.g_backward"]["busy_ms"] == pytest.approx(2.0)
    assert out["train.g_backward"]["launches"] == 1
    assert out["train.step"]["busy_ms"] == pytest.approx(2.0)
    assert "vil.conv1d" not in out


def test_nested_spans_attribute_to_the_innermost_and_sum_inclusively():
    annotations = [span("train.step", 0, 20), span("train.g_forward", 1, 10),
                   span("vil.conv1d", 2, 3), span("vil.conv1d", 4, 5),
                   span("train.d_forward", 11, 12)]
    launches = [launch(1, 2.5), launch(2, 4.5), launch(3, 6), launch(4, 11.5),
                launch(5, 11.6)]
    ops = [kernel(1, 3, 4), kernel(2, 5, 6), kernel(3, 7, 9),
           # two launches whose device intervals overlap count their union
           kernel(4, 12, 14), kernel(5, 13, 15)]
    out = spans.attribute(annotations, launches, ops, (0, ns(20)), 1)
    assert out["vil.conv1d"]["busy_ms"] == pytest.approx(2.0)
    assert out["vil.conv1d"]["calls"] == 2 and out["vil.conv1d"]["launches"] == 2
    assert out["train.g_forward"]["busy_ms"] == pytest.approx(4.0)
    assert out["train.g_forward"]["launches"] == 3
    assert out["train.d_forward"]["busy_ms"] == pytest.approx(3.0)
    assert out["train.step"]["busy_ms"] == pytest.approx(7.0)
    assert out["train.step"]["launches"] == 5
    assert None not in out or out[None]["busy_ms"] == 0


def test_an_idle_gap_goes_to_the_span_open_when_it_began():
    """The gap from 4 to 7 begins inside `train.g_backward` and ends inside
    `train.g_adam`: all of it is the backward's. The window's edges count."""
    annotations = [span("train.step", 0.5, 9.5), span("train.g_backward", 1, 5),
                   span("train.g_adam", 5, 9)]
    launches = [launch(1, 1.5), launch(2, 5.5)]
    ops = [kernel(1, 2, 4), kernel(2, 7, 9.5)]
    out = spans.attribute(annotations, launches, ops, (0, ns(12)), 1)
    assert out["train.g_backward"]["idle_ms"] == pytest.approx(3.0)
    assert out["train.g_adam"]["idle_ms"] == 0
    assert out["train.step"]["idle_ms"] == pytest.approx(3.0)
    # before the first operation, and after the last, outside every span
    assert out[None]["idle_ms"] == pytest.approx(2.0 + 2.5)


def test_operations_launched_outside_every_span():
    annotations = [span("sweep.prefix", 1, 2)]
    launches = [launch(1, 1.5), launch(2, 3), launch(3, 0.5)]
    # copies and sets are device time but not launches; op 9 has no launch call
    ops = [kernel(1, 2, 3), kernel(2, 3, 4, "Memcpy HtoD"), kernel(3, 4, 5),
           kernel(9, 5, 6)]
    out = spans.attribute(annotations, launches, ops, (0, ns(6)), 1)
    assert out["sweep.prefix"]["busy_ms"] == pytest.approx(1.0)
    assert out[None]["busy_ms"] == pytest.approx(3.0)
    assert out[None]["launches"] == 2


def test_values_are_per_unit():
    annotations = [span("sweep.suffix", 0, 1), span("sweep.suffix", 2, 3)]
    launches = [launch(1, 0.5), launch(2, 2.5)]
    ops = [kernel(1, 1, 2), kernel(2, 3, 5)]
    out = spans.attribute(annotations, launches, ops, (0, ns(6)), 2)
    assert out["sweep.suffix"] == pytest.approx(
        {"busy_ms": 1.5, "idle_ms": 1.0, "launches": 1.0, "calls": 1.0})
    assert out[None]["idle_ms"] == pytest.approx(0.5)


def test_a_reader_without_its_spans_a_trace_or_a_unit_reads_none(monkeypatch):
    from perfbench.layer_metrics import bwd_idle_ms, fwd_ms

    found = {None: {"busy_ms": 1.0, "idle_ms": 3.0, "launches": 1.0, "calls": 0.0}}
    monkeypatch.setattr(spans, "table", lambda trace, units: found)
    assert fwd_ms.read(SimpleNamespace(trace=None, units=3)) is None
    assert fwd_ms.read(SimpleNamespace(trace=object(), units=0)) is None
    ctx = SimpleNamespace(trace=object(), units=1)
    assert fwd_ms.read(ctx) is None and bwd_idle_ms.read(ctx) is None
    found["train.d_backward"] = {"busy_ms": 2.0, "idle_ms": 0.25, "launches": 4.0,
                                 "calls": 1.0}
    assert bwd_idle_ms.read(ctx) == pytest.approx(0.25)
