"""Logging and observability (counterpart of `xlstm_hved_tpu/utils/logging.py`):
CSV metric logs, running averages, a stream logger, `span` (a named range
of the program on the profiler's clock, and its wall seconds in a table),
the time a loop waits on its iterator, and a `torch.profiler` trace scope."""
from __future__ import annotations

import contextlib
import csv
import logging
import os
import sys
import time
from typing import Dict, Iterable, Iterator, Optional, TypeVar

import torch

T = TypeVar("T")


def get_logger(name: str, level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(level)
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s [%(threadName)s] %(levelname)s %(name)s - %(message)s"))
        logger.addHandler(h)
    return logger


class RunningAverage:
    """Incremental mean."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0

    def update(self, value: float, n: int = 1):
        self.count += n
        self.sum += float(value) * n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class CSVLogger:
    """Append-style CSV metric log with a fixed header, written once when
    the file is new (a resumed run appends below the earlier rows)."""

    def __init__(self, path: str, fieldnames: Iterable[str]):
        self.path = path
        self.fieldnames = list(fieldnames)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(self.fieldnames)

    def append(self, row: Dict[str, float]):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(k, "") for k in self.fieldnames])


class _Span:
    __slots__ = ("name", "table", "range", "t0")

    def __init__(self, name: str, table: Optional[Dict[str, float]], traced: bool):
        self.name, self.table = name, table
        self.range = torch.profiler.record_function(name) if traced else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.table is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.table is not None:
            self.table[self.name] = (self.table.get(self.name, 0.0)
                                     + time.perf_counter() - self.t0)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, table: Optional[Dict[str, float]] = None):
    """A named range of the program: `with span("train.g_backward"): ...`.

    While a torch.profiler is recording it is a `record_function` range, on
    the same clock as the device operations the profiler traces (the ranges
    say which part of the program launched each kernel). With `table` it
    also adds its wall seconds to table[name]. With neither it costs one
    flag check: no range object, no dispatcher call. It never synchronises
    the device.

    The names the program's hot path opens (`train.*` in engine/train.py,
    `sweep.prefix` / `sweep.suffix` in engine/evaluate.py, `vil.conv1d` in
    nn/vil.py, `rsm.gate` in nn/blocks.py, `segtrain.*` in
    engine/seg_train.py, `vil.mixer` / `uxlstm.norm` in models/uxlstm.py)
    are read by the benchmark's per-layer metrics (perfbench/spans.py,
    perfbench/layer_metrics/): they are part of its contract, and a metric
    whose span is renamed or removed reads nothing until the benchmark
    follows."""
    traced = torch.autograd._profiler_enabled()
    if table is None and not traced:
        return _OFF
    return _Span(name, table, traced)


def timed_iter(iterable: Iterable[T], spans: Dict[str, float],
               key: str = "wait") -> Iterator[T]:
    """Yield from `iterable`, each wait for an item a `span(key, spans)`:
    its seconds added to spans[key], and a range in a profiler trace."""
    it = iter(iterable)
    try:
        while True:
            with span(key, spans):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """torch.profiler trace of the CPU and, when there is one, the CUDA
    device, written as a Chrome trace under `log_dir`; no-op when log_dir
    is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
