"""The correctness check comes out false on a broken timed path.

On the CPU at 32^3, past the harness's look for a card: a run of each
cell's driver with a fault planted underneath it (in the program), read
against the cell's own limits; and each cell's control, the plain
reference in fp8 with its ViL in bf16 (`reference/precision.py`) put in
the program's place. The cells' limits are set from readings at their own
size on the card (PERF.md §2).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import calibrate, harness  # noqa: E402
from perfbench.drivers import program  # noqa: E402
from perfbench.drivers import sweep as sw  # noqa: E402
from perfbench.drivers import train_step as ts  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 77
CROP = [32, 32, 32]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cell_at(name, **traffic):
    cell = harness.load_cell(name)
    cell.traffic = dict(cell.traffic, crop=CROP, **traffic)
    return cell


def run_train(monkeypatch):
    """The step returns its state unchanged: it runs, and puts G's and D's
    parameters back as they were."""
    from xlstm_hved_torch.engine import train as engine

    make = engine.make_train_step

    def make_broken(model, disc, *a, **k):
        step = make(model, disc, *a, **k)

        def broken(state, x, mask):
            params = list(state.model.parameters()) + list(state.disc.parameters())
            before = [p.detach().clone() for p in params]
            state, metrics = step(state, x, mask)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            return state, metrics

        return broken

    monkeypatch.setattr(engine, "make_train_step", make_broken)
    cell = cell_at("xlstm_hved.train_step")
    return ts.run(cell, SEED, 0.01, False, CPU, time.perf_counter())


def test_train_step_left_unchanged_is_not_correct(monkeypatch):
    """The training cell's faults: batch 1 on one card has no half batch to
    leave out and no exchange between cards; its answer is its state and
    the outputs it is computed from (PERF.md §2)."""
    w = run_train(monkeypatch)
    assert not harness.correct(w.checks), w.checks


def test_train_step_with_its_segmentation_altered_is_not_correct(monkeypatch):
    """G's segmentation inverted (1 - p) where it is produced, in the
    program."""
    build = program.build_program
    monkeypatch.setattr(program, "build_program", lambda *a, **k: (
        lambda g, d: (calibrate.altered(g), d))(*build(*a, **k)))
    cell = cell_at("xlstm_hved.train_step")
    w = ts.run(cell, SEED, 0.01, False, CPU, time.perf_counter())
    assert not harness.correct(w.checks), w.checks
    assert w.checks["stage_gap"][0] > 0.5, w.checks


def test_train_step_control_is_not_correct():
    cell = cell_at("xlstm_hved.train_step")
    x, mask, wg, wd = ts.make_inputs(cell, SEED, CPU)
    ctl, _ = ts.reference_first_steps(cell, x, mask, wg, wd, SEED, CPU,
                                      cell.traffic["checked_steps"], "float8", record=True)
    got, _, _ = ts.check(cell, x, mask, wg, wd, SEED, CPU, ctl)
    checks = ts.compare(got, cell.limits)
    assert not harness.correct(checks), checks


def run_sweep(monkeypatch, fault):
    from xlstm_hved_torch.engine import evaluate

    make = evaluate.make_hoisted_subset_sweep
    cell = cell_at("u_hved_conv_xlstm.sweep", warmup=1, draw_from=1)
    hit = sw.checked_subsets(SEED, cell.traffic)[0]

    def make_broken(model, *a, **k):
        if fault == "vil_skipped":  # the ViL block hands its input on
            model.get_submodule("sdecoder_0.basic.vil").forward = lambda x: x
        sweep = make(model, *a, **k)

        def broken(net, x):
            seg, rec = sweep(net, x)
            seg, rec = seg.clone(), rec.clone()
            if fault == "altered":  # one subset the check samples
                seg[hit] = 1.0 - seg[hit]
                rec[hit] = -rec[hit]
            elif fault == "seg_altered":  # its segmentation alone
                seg[hit] = 1.0 - seg[hit]
            elif fault == "half_left_out":
                seg[8:] = 0.0
                rec[8:] = 0.0
            return seg, rec

        return broken

    monkeypatch.setattr(evaluate, "make_hoisted_subset_sweep", make_broken)
    return sw.run(cell, SEED, 0.01, False, CPU, time.perf_counter())


@pytest.mark.parametrize("fault", ["altered", "half_left_out", "seg_altered", "vil_skipped"])
def test_sweep_fault_is_not_correct(monkeypatch, fault):
    w = run_sweep(monkeypatch, fault)
    assert not harness.correct(w.checks), (fault, w.checks)
    if fault in ("seg_altered", "vil_skipped"):  # the segmentation's path alone
        assert w.checks["recon_gap_x"][0] <= w.checks["recon_gap_x"][1], w.checks


def test_sweep_control_is_not_correct():
    cell = cell_at("u_hved_conv_xlstm.sweep")
    x, wg = sw.make_inputs(cell, SEED, CPU)
    subsets = sw.checked_subsets(SEED, cell.traffic)
    seg, rec, records = calibrate.control_sweep(cell, x[0], wg, CPU, subsets)
    got, _ = sw.check(cell, x, wg, {"drawn": (0, seg, rec)}, records, CPU, subsets)
    checks = {k: (got[k], lim) for k, lim in cell.limits.items()}
    assert not harness.correct(checks), checks
