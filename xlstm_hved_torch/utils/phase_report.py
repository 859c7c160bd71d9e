"""What one phase of a run cost and which mLSTM path it took: its seconds,
its peak device memory and peak host RSS, and the calls of the three
kernel wrappers and of the plain scan.

`measure()` wraps a phase that runs in this process. A phase in a process
of its own runs as

    python -m xlstm_hved_torch.utils.phase_report REPORT.json MODULE [ARGS...]

which runs `python -m MODULE ARGS...` inside `measure()` and writes the
record to REPORT.json when the module returns (a module that raises writes
none and the process exits non-zero). The counters start at 0 in a new
process; `measure()` sets them to 0 itself.

Peak host RSS is the process's peak RSS (getrusage's ru_maxrss) at the end
of the phase: the phase's own peak for a phase in a process of its own,
the peak so far for one in a longer process (no portable way resets it).
Peak device memory is
`torch.cuda.max_memory_allocated` since the start of the phase; None when
the phase never touched a card. `rss_samples` follows a process's RSS over
the phase, to show whether host memory grows with the steps.
"""
from __future__ import annotations

import contextlib
import json
import re
import resource
import runpy
import sys
import threading
import time
from typing import Dict, Iterator, List, Tuple

import torch

from xlstm_hved_torch.ops import mlstm_cuda
from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise

GIB = 2 ** 30


def _counters():
    return {"mlstm_fwd": mlstm_cuda.run_kernel, "mlstm_fwd_states": mlstm_cuda.run_states_kernel,
            "mlstm_bwd": mlstm_cuda.run_bwd_kernel}


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launches and the plain scan's calls."""
    counts = {name: fn.launches for name, fn in _counters().items()}
    counts["plain_scan"] = mlstm_chunkwise.calls
    return counts


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
    mlstm_chunkwise.calls = 0


def _peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024   # Linux: kB


def _rss_gib(pid: int) -> float:
    """Process `pid`'s RSS; ProcessLookupError once it has ended (a zombie's
    status has no VmRSS line, a reaped process no status file)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            m = re.search(r"VmRSS:\s+(\d+) kB", f.read())
    except FileNotFoundError:
        m = None
    if m is None:
        raise ProcessLookupError(pid)
    return int(m.group(1)) * 1024 / GIB


@contextlib.contextmanager
def rss_samples(pid: int, every: float = 15.0) -> Iterator[List[Tuple[float, float]]]:
    """Yields a list that a thread fills with (seconds, RSS GiB) of process
    `pid` every `every` seconds until the block ends or the process is gone."""
    samples: List[Tuple[float, float]] = []
    stop = threading.Event()
    t0 = time.perf_counter()

    def sample():
        while not stop.wait(every):
            try:
                samples.append((round(time.perf_counter() - t0, 1), round(_rss_gib(pid), 4)))
            except ProcessLookupError:
                return

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield samples
    finally:
        stop.set()
        thread.join()


@contextlib.contextmanager
def measure() -> Iterator[dict]:
    """Yields a dict that holds, once the block has finished: seconds,
    peak_device_gib, peak_rss_gib and launches (`launch_counts()`)."""
    record: dict = {}
    reset_counts()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    yield record
    device = None
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        device = torch.cuda.max_memory_allocated() / GIB
    record.update(seconds=time.perf_counter() - t0, peak_device_gib=device,
                  peak_rss_gib=_peak_rss_bytes() / GIB, launches=launch_counts())


def main() -> None:
    report, module, *args = sys.argv[1:]
    sys.argv = [module, *args]
    with measure() as record:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    with open(report, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
