"""`perfbench/layer_metrics/gate_ms.py` on hand-built timelines: the device
time launched under the program span `rsm.gate`, read like `conv1d_ms` reads
`vil.conv1d`, from a traced window whose profiler events are made here.

    python -m pytest -q perfbench/tests/test_perfbench_gate_ms.py
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from perfbench import spans
from perfbench.layer_metrics import gate_ms

MAIN, AUTOGRAD = 11, 22
MS = 1_000_000  # ns
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """The fields of a kineto event that spans.events and gate_ms read."""

    def __init__(self, name, start, end, device=CPU, corr=0, thread=MAIN):
        self._name, self._s, self._d = name, int(start * MS), int((end - start) * MS)
        self._device, self._corr, self._thread = device, corr, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return False


class Trace:
    """A harness.Trace's window as spans.events reads it (hashable, as the
    readers' cached table takes it)."""

    MARK = "perfbench.window"

    def __init__(self, events, window=(0, 20)):
        results = SimpleNamespace(events=lambda: events)
        self.prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
        self.window = (window[0] * MS, window[1] * MS)


def kernel(corr, start, end, name="kernel"):
    return Event(name, start, end, device=CUDA, corr=corr)


def launch(corr, at):
    return Event("cudaLaunchKernel", at, at + 0.01, corr=corr)


@pytest.fixture(autouse=True)
def fresh_table():
    gate_ms.table.cache_clear()
    yield
    gate_ms.table.cache_clear()


def test_gates_nested_in_suffixes_count_their_own_launches():
    """Two sweeps' suffixes each open a gate; the gate's kernel counts,
    the suffix's other kernel does not; the sum is per unit."""
    events = [Event("sweep.suffix", 0, 8), Event("rsm.gate", 1, 2), Event("sweep.suffix", 10, 18),
              Event("rsm.gate", 11, 12),
              launch(1, 1.5), launch(2, 3), launch(3, 11.5),
              kernel(1, 2, 3.5, "gate_conv_kernel"), kernel(2, 4, 6), kernel(3, 12, 13.5)]
    ctx = SimpleNamespace(trace=Trace(events), units=2)
    assert gate_ms.read(ctx) == pytest.approx(1.5)
    found = gate_ms.table(ctx.trace, 2)
    assert found["rsm.gate"]["calls"] == 1 and found["rsm.gate"]["launches"] == 1
    # the spans the benchmark reads already are attributed as spans.table has them
    assert found["sweep.suffix"]["busy_ms"] == pytest.approx(
        spans.attribute(*spans.events(ctx.trace), ctx.trace.window, 2)["sweep.suffix"]["busy_ms"])


def test_a_gate_opened_on_another_thread_is_left_out():
    """A gate that autograd's thread opens (a recomputed forward in the
    backward) is not the step's; its kernel goes to the step's open span."""
    events = [Event("train.step", 0, 10), Event("train.g_forward", 0.5, 3),
              Event("rsm.gate", 1, 2), Event("train.g_backward", 4, 9),
              Event("rsm.gate", 5, 6, thread=AUTOGRAD),
              launch(1, 1.5), launch(2, 5.5), kernel(1, 2, 3), kernel(2, 6, 7.5)]
    ctx = SimpleNamespace(trace=Trace(events), units=1)
    assert gate_ms.read(ctx) == pytest.approx(1.0)
    assert gate_ms.table(ctx.trace, 1)["train.g_backward"]["busy_ms"] == pytest.approx(1.5)


def test_without_the_span_a_trace_or_a_unit_it_reads_none():
    """A program older than the span (the parent of the change that opens
    it) reads None and does not raise."""
    events = [Event("sweep.suffix", 0, 8), launch(1, 1.5), kernel(1, 2, 3)]
    assert gate_ms.read(SimpleNamespace(trace=Trace(events), units=1)) is None
    assert gate_ms.read(SimpleNamespace(trace=None, units=1)) is None
    assert gate_ms.read(SimpleNamespace(trace=Trace(events), units=0)) is None
