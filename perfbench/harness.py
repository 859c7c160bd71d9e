"""What every cell's run shares: the manifest and the files it names, the
card check, the import guard, the profiler window and its reading, the
per-layer readers, the comparison numbers and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name in
`BENCHMARK.json`:
- `perfbench/configs/<config>.json`: the model, its widths and dtypes, the
  training settings; its "source", "reduced" and "assumed";
- `perfbench/traffic/<traffic>.json`: the driver that generates the load
  ("driver", a module of `perfbench/drivers/`) and its parameters;
- `perfbench/limits/<cell>.json`: the limit of each number compared;
- `perfbench/layer_metrics/<family>.py`: the reader of every per-layer
  metric named `<family>` or `<family>.<anything>`.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
# top-level module names no run may load: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "xlstm_hved_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in reported and reports(m, name)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: this cell needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        raise SystemExit(3)


def reader(family: str):
    return importlib.import_module(f"perfbench.layer_metrics.{family}")


# ------------------------------------------------------------ the profiler


# a kernel's name in the breakdown: its first characters (templates run long)
NAME_CHARS = 160


class Trace:
    """torch.profiler over the measured window. After the block: `kernels`,
    the device operations (kernels, copies, sets) as (name, start_ns,
    end_ns); `host`, the host operations as the same; `window`, the
    (start_ns, end_ns) of the window's own range."""

    MARK = "perfbench.window"

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(self.MARK)
        self.mark.__enter__()
        self._torch = torch
        return self

    def __exit__(self, *exc):
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        self.kernels, self.host, self.window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == self._torch.autograd.DeviceType.CUDA:
                # the window's own range is mirrored on the device's timeline
                if not e.is_user_annotation() and e.name() != self.MARK:
                    self.kernels.append(span)
            elif e.name() == self.MARK:
                self.window = span[1:]
            else:
                self.host.append(span)
        lo, hi = self.window
        self.kernels = sorted(k for k in self.kernels if lo <= k[1] and k[2] <= hi)
        self.host = sorted(h for h in self.host if lo <= h[1] and h[2] <= hi)
        return False

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self, names: Optional[Sequence[str]] = None) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals (of those whose
        names contain one of `names`, when given)."""
        spans = sorted((s, e) for n, s, e in self.kernels
                       if names is None or any(k in n for k in names))
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, names: Optional[Sequence[str]] = None) -> float:
        return sum(e - s for s, e in self.busy_intervals(names)) * 1e-9

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time (summed by name) and
        the longest idle gaps, each named by the innermost host operation
        running when it began."""
        by_name: Dict[str, int] = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0) + e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for se in busy for x in se] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        named = []
        for length, start in gaps:
            doing = [h for h in self.host if h[1] <= start < h[2]]
            inner = min(doing, key=lambda h: h[2] - h[1])[0] if doing else "(no host op)"
            named.append([inner[:NAME_CHARS], length * 1e-9])
        return {"device_ops": [[n[:NAME_CHARS], t * 1e-9] for n, t in ops],
                "idle_gaps": named}


@dataclasses.dataclass
class Window:
    """What a driver hands back: the units of work done in the window and
    its length, set-up seconds, the per-unit times, the peak device memory,
    the numbers compared with their limits, the work attempted and failed,
    the trace (with --trace 1) and the reference's operations per unit."""

    units: int
    window_s: float
    setup_s: float
    unit_times: List[float]
    memory_peak_bytes: int
    checks: Dict[str, Tuple[float, float]]
    attempted: int
    failed: int
    trace: Optional[Trace] = None
    flops_per_unit: Optional[float] = None
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


def correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(v == v and v <= lim for v, lim in checks.values())


# -------------------------------------------------------- the numbers compared


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leave_out: Sequence[str] = ()) -> Tuple[float, str]:
    """The largest |prog - ref| over the leaves, each against the larger of
    its own reference norm and the median leaf's; (gap, leaf)."""
    norms = sorted(ref.values())
    median = norms[len(norms) // 2]
    worst = (0.0, "")
    for name, r in ref.items():
        if name in leave_out:
            continue
        gap = abs(prog[name] - r) / max(r, median, 1e-30)
        if not gap <= worst[0]:
            worst = (gap, name)
    return worst


def median_leaf(prog: Dict[str, float], ref: Dict[str, float],
                leave_out: Sequence[str] = ()) -> Tuple[float, str]:
    """The median over the leaves of the same gaps as `worst_leaf`; (gap, "")."""
    import statistics

    norms = sorted(ref.values())
    median = norms[len(norms) // 2]
    gaps = [abs(prog[n] - r) / max(r, median, 1e-30) for n, r in ref.items()
            if n not in leave_out]
    return statistics.median(gaps), ""


def quartiles(values: Sequence[float]) -> Tuple[float, float, float]:
    import statistics

    if len(values) < 2:
        v = values[0] if values else float("nan")
        return v, v, v
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q1, q2, q3
