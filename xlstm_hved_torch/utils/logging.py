"""Logging and observability (counterpart of `xlstm_hved_tpu/utils/logging.py`):
CSV metric logs, running averages, a stream logger, a wall-clock span, the
time a loop waits on its iterator, and a `torch.profiler` trace scope."""
from __future__ import annotations

import contextlib
import csv
import logging
import os
import sys
import time
from typing import Dict, Iterable, Iterator, Optional, TypeVar

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


@contextlib.contextmanager
def step_timer(label: str, logger: Optional[logging.Logger] = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = f"{label}: {dt:.3f}s"
    (logger.info if logger else print)(msg)


def timed_iter(iterable: Iterable[T], spans: Dict[str, float],
               key: str = "wait") -> Iterator[T]:
    """Yield from `iterable`, adding the seconds spent waiting for each item
    to spans[key]."""
    it = iter(iterable)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
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
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
