"""The plain reference against the program (`xlstm_hved_torch`) on the CPU
at a small crop, both in fp32 from the same weights: one training step's
readings and one sweep. And the reference's chunked mLSTM against its
quadratic form."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness  # noqa: E402
from perfbench.drivers import sweep as sw  # noqa: E402
from perfbench.drivers import train_step as ts  # noqa: E402
from perfbench.reference.mlstm import mlstm_chunked, mlstm_quadratic  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 5


def fp32_cell(name, crop):
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"]["compute_dtype"] = "float32"
    if "disc" in cell.config:
        cell.config["disc"]["dtype"] = "float32"
    cell.traffic = dict(cell.traffic, crop=crop)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("S, chunk", [(64, 16), (100, 32), (48, 128)])
def test_chunked_mlstm_is_the_quadratic_sum(S, chunk):
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(2, 3, S, 8, generator=g, dtype=torch.float64) for _ in range(3))
    ig = torch.randn(2, 3, S, generator=g, dtype=torch.float64) * 3
    fg = torch.randn(2, 3, S, generator=g, dtype=torch.float64) + 3
    want = mlstm_quadratic(q.double(), k.double(), v.double(), ig.double(), fg.double())
    got = mlstm_chunked(q, k, v, ig, fg, chunk)
    torch.testing.assert_close(got.double(), want.double(), rtol=1e-4, atol=1e-5)


def test_one_training_step_matches_the_program():
    torch.set_num_threads(1)  # one thread sums in one order: the run repeats
    """fp32 both sides, 32^3, the first steps of the cell: the same subsets,
    the first step's loss terms within 1e-4 and the second's within 2e-2
    each (Adam's first update moves an element by about the learning rate
    whatever its gradient's size, so rounding reaches the second step's D
    losses), the median leaf of the change within 1e-2 (the worst leaves
    are the scale-invariant ones before InstanceNorm, whose gradient is
    rounding; PERF.md), and the first step followed stage by stage: every
    stage, the ViL, the loss terms and the BatchNorm statistics within
    1e-4 (the reference's stages are the program's module tree)."""
    cell = fp32_cell("xlstm_hved.train_step", [32, 32, 32])
    x, mask, wg, wd = ts.make_inputs(cell, SEED, CPU)
    state, step = ts.build_step(cell, wg, wd, SEED, CPU)
    prog = ts.program_first_steps(cell, state, step, x, mask, wg, wd, 2, 2)
    got, _, followed = ts.check(cell, x, mask, wg, wd, SEED, CPU, prog)
    ref, _ = ts.reference_first_steps(cell, x, mask, wg, wd, SEED, CPU, 2)
    assert got["subsets"] == 0
    for k in ts.LOSS_KEYS:
        assert harness.rel_gap(prog.losses[0][k], ref.losses[0][k]) < 1e-4, k
    for k in ts.LOSS_KEYS:
        assert harness.rel_gap(prog.losses[1][k], ref.losses[1][k]) < 2e-2, k
    assert got["change_gap_median"] < 1e-2, got
    names_g, names_d, vil = ts.stage_plan(cell.config)
    assert {f"G.{n}" for n in names_g} | {f"D.{n}" for n in names_d} <= set(followed)
    for k in ("stage_gap", "vil_gap", "loss_gap", "stats_gap"):
        assert got[k] < 1e-4, (k, got)


def test_one_sweep_matches_the_program():
    """The hoisted sweep (fp32, 32^3, all 15 subsets) against the plain
    reference sweep, end to end and followed stage by stage."""
    cell = fp32_cell("u_hved_conv_xlstm.sweep", [32, 32, 32])
    x, wg = sw.make_inputs(cell, SEED, CPU)
    model, sweep = sw.build_sweep(cell, wg, CPU)
    subsets = list(range(15))
    hooks = sw.recorder(sw.stage_plan(cell.config), model, subsets)
    seg, rec = sweep(model, x[1])
    hooks.remove()
    got, followed = sw.check(cell, x, wg, {"drawn": (1, seg, rec)}, hooks.records, CPU, subsets)
    assert set(sw.stage_plan(cell.config)[0]) <= set(followed)
    assert got["stage_gap"] < 1e-4 and got["vil_gap"] < 1e-4, got
    assert got["recon_gap"] < 1e-3, got


def test_a_run_of_the_sweep_driver_is_correct_on_the_cpu():
    """The driver end to end at 32^3, fp32: a window, the kept sweeps
    checked."""
    cell = fp32_cell("u_hved_conv_xlstm.sweep", [32, 32, 32])
    cell.traffic = dict(cell.traffic, warmup=1, draw_from=1)
    w = sw.run(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert w.units >= 1 and w.failed == 0
    assert harness.correct(w.checks), w.checks
