"""The UxLSTM cell (`uxlstm_enc_3d.ds_sgd_step`) on the CPU: its driver
(`drivers/ds_sgd_step.py`) at a small plan, built as a `harness.Cell` with
small traffic; the control and each planted fault against the cell's own
limits; and its six readers on hand-built timelines.

    python -m pytest -q perfbench/tests/test_perfbench_uxlstm.py

The small plan: 32^3, 5 stages of 4 .. 64 features (a ViL over patch tokens
at stage 3, over channel tokens at stage 4), batch 2, two batches in the
pool. The cell's limits are set from readings at its own size on the card
(PERF.md §2).
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness, run  # noqa: E402
from perfbench.drivers import ds_sgd_step as ds  # noqa: E402
from perfbench.drivers import uxlstm  # noqa: E402
from perfbench.layer_metrics import (ds_loss_ms, seg_bwd_idle_ms, seg_bwd_ms,  # noqa: E402
                                     seg_fwd_ms, sgd_ms, vil_mixer_ms)
from test_perfbench_gate_ms import Event, Trace, kernel, launch  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 211
CELL = "uxlstm_enc_3d.ds_sgd_step"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(dtype: str) -> harness.Cell:
    """The cell with the small plan in its configuration and small traffic."""
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(
        patch_size=[32] * 3, conv_kernel_sizes=[[3, 3, 3]] * 5,
        pool_op_kernel_sizes=[[1, 1, 1]] + [[2, 2, 2]] * 4, n_conv_per_stage_encoder=[2] * 5,
        n_conv_per_stage_decoder=[2] * 4, UNet_base_num_features=4, unet_max_num_features=64,
        features_per_stage=[4, 8, 16, 32, 64], mixers=["conv"] * 3 + ["vil"] * 2,
        channel_token=[False] * 4 + [True], compute_dtype=dtype)
    cell.traffic = dict(cell.traffic, patch=[32] * 3, pool=2, first_steps=2)
    uxlstm.program_config(cell.config["model"])
    return cell


def run_cell(cell) -> harness.Window:
    return ds.run(cell, SEED, 0.01, False, CPU, time.perf_counter())


def test_driver_runs_correct_at_a_small_plan():
    """fp32 on the CPU: the program follows the reference stage by stage,
    and the result line holds the cell's end-to-end metrics."""
    cell = small_cell("float32")
    w = run_cell(cell)
    assert harness.correct(w.checks) and w.failed == 0 and w.units >= 1, w.checks
    assert set(run.metrics_of(cell, w, False)) == {"setup_s", "step_ms"}
    assert set(w.checks) == set(cell.limits)


def _unchanged(monkeypatch):
    """The step runs and puts the parameters back as they were."""
    from xlstm_hved_torch.engine import seg_train

    make = seg_train.make_ds_train_step

    def make_broken(model, cfg):
        step = make(model, cfg)

        def broken(state, x, targets):
            before = [p.detach().clone() for p in model.parameters()]
            state, loss = step(state, x, targets)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return state, loss

        return broken

    monkeypatch.setattr(seg_train, "make_ds_train_step", make_broken)


def _head_dropped(monkeypatch):
    """The 1/2-scale head's loss weight 0."""
    from xlstm_hved_torch.engine import seg_train

    weights = seg_train.deep_supervision_weights
    monkeypatch.setattr(seg_train, "deep_supervision_weights",
                        lambda n: [0.0 if i == 1 else w for i, w in enumerate(weights(n))])


def _vil_skipped(monkeypatch):
    """The patch-token ViL mixer hands its input on."""
    build = uxlstm.build_program

    def broken(*a, **k):
        net = build(*a, **k)
        net.encoder.mixer3.forward = lambda x: x
        return net

    monkeypatch.setattr(uxlstm, "build_program", broken)


@pytest.mark.parametrize("fault,number", [(_unchanged, "change_gap_median"),
                                          (_head_dropped, "loss_gap"),
                                          (_vil_skipped, "vil_gap")])
def test_a_planted_fault_is_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    w = run_cell(small_cell("bfloat16"))
    assert not harness.correct(w.checks), w.checks
    value, limit = w.checks[number]
    assert value > limit, w.checks


@pytest.mark.parametrize("kind", sorted(ds.MLSTM_FAULTS))
def test_a_fault_in_the_mlstm_backward_is_not_correct(kind):
    """A fault in the mLSTM's backward alone (q's gradient halved, the
    forget gate's zeroed): the forward still reads correct, the ViL mixers'
    backward followed from the program's own values does not."""
    with ds.mlstm_fault(kind):
        w = run_cell(small_cell("bfloat16"))
    assert not harness.correct(w.checks), w.checks
    value, limit = w.checks["vil_grad_gap"]
    assert value > limit, w.checks
    assert w.checks["vil_gap"][0] <= w.checks["vil_gap"][1], w.checks


def test_vil_backward_records_each_mixer_once():
    """The first step's backward leaves, for each ViL mixer, its input's and
    output's cotangents and a gradient for every one of its parameters."""
    cell = small_cell("float32")
    x, targets, weights = ds.make_inputs(cell, SEED, CPU)
    state, step = ds.build_step(cell, weights, CPU)
    side = ds.program_first_steps(cell, state, step, x, targets, weights, 2, 2)
    vil = ds.stage_plan(cell.config)[1]
    assert vil == ["encoder.mixer3", "encoder.mixer4"]
    assert set(side.vil_dy) == set(side.vil_dx) == set(vil)
    mixers = {f"{m}.{k}" for m in vil
              for k, _ in state.model.get_submodule(m).named_parameters()}
    assert set(side.vil_grads) == mixers
    for m in vil:
        assert side.vil_dx[m].shape == side.records[("in", m, 0)][0][0].shape


def test_leaves_left_out_are_the_norm_fed_biases_and_the_unreached_head():
    """Every residual block's conv1 and conv2 biases (each feeds an instance
    norm, which takes its gradient away) and the leaves the first gradient
    does not reach; a skip conv's bias and every other leaf stay in."""
    cell = small_cell("float32")
    ref = uxlstm.reference_module(cell.config["model"], "meta")
    grad1 = {k: 0.0 if k.startswith("decoder.seg4.") else 1.0 for k, _ in ref.named_parameters()}
    out = set(ds.leaves_left_out(cell.config, grad1))
    assert {"encoder.stem_res.conv1.bias", "encoder.stem_res.conv2.bias",
            "decoder.dec1_res.conv2.bias", "decoder.seg4.weight", "decoder.seg4.bias"} <= out
    assert not {"encoder.stem_res.conv3.bias", "encoder.stem_res.conv1.weight",
                "encoder.stem_res.norm1.bias", "decoder.up1_conv.bias",
                "decoder.seg1.bias"} & out
    assert all(k in grad1 for k in out)
    x, targets, weights = ds.make_inputs(cell, SEED, CPU)
    ref_readings, _ = ds.reference_first_steps(cell, x, targets, weights, CPU, 1)
    fed = [k for k in out if not k.startswith("decoder.seg4.")]
    median = sorted(ref_readings.grad1.values())[len(grad1) // 2]
    assert max(ref_readings.grad1[k] for k in fed) < 1e-3 * median


def test_control_is_not_correct():
    """The reference with its convs in fp8 and its ViL in bf16, in the
    program's place."""
    cell = small_cell("bfloat16")
    x, targets, weights = ds.make_inputs(cell, SEED, CPU)
    ctl, _ = ds.reference_first_steps(cell, x, targets, weights, CPU,
                                      cell.traffic["checked_steps"], "float8", record=True)
    got, _, _ = ds.check(cell, x, targets, weights, CPU, ctl)
    checks = ds.compare(got, cell.limits)
    assert not harness.correct(checks), checks


# one step of the timeline: its spans, (name, start, end) in ms
STEP = [("segtrain.step", 0, 10), ("segtrain.forward", 0.2, 4), ("vil.mixer", 1, 2),
        ("segtrain.loss", 4, 5), ("segtrain.backward", 5, 9), ("segtrain.sgd", 9, 10)]


def test_readers_take_their_spans():
    """Two steps: a kernel in the forward outside the mixer, one in the
    mixer, one in the loss, two in the backward, one in the update; each
    reader gives its span's device ms per step (inclusive: the mixer's
    kernel counts in the forward too)."""
    events = [Event(n, s + off, e + off) for off in (0, 10) for n, s, e in STEP]
    corr = 0
    for off in (0, 10):
        for at, start, end in ((0.5, 0.6, 1.0), (1.5, 1.6, 1.9), (4.5, 4.6, 4.8),
                               (5.5, 5.6, 6.6), (7.5, 7.6, 8.0), (9.5, 9.6, 9.7)):
            corr += 1
            events += [launch(corr, at + off), kernel(corr, start + off, end + off)]
    ctx = SimpleNamespace(trace=Trace(events), units=2)
    ns = 1e-5  # the hand-built times are whole nanoseconds
    assert seg_fwd_ms.read(ctx) == pytest.approx(0.4 + 0.3, abs=ns)
    assert vil_mixer_ms.read(ctx) == pytest.approx(0.3, abs=ns)
    assert ds_loss_ms.read(ctx) == pytest.approx(0.2, abs=ns)
    assert seg_bwd_ms.read(ctx) == pytest.approx(1.0 + 0.4, abs=ns)
    assert sgd_ms.read(ctx) == pytest.approx(0.1, abs=ns)


def test_backward_idle_reads_the_gaps_begun_in_the_backward():
    """The device idle inside `segtrain.backward` (5.0-5.6, 6.6-7.6,
    8.0-9.0 of each step) counts; the gaps begun in the other spans do
    not."""
    events = [Event(n, s + off, e + off) for off in (0, 10) for n, s, e in STEP]
    corr = 0
    for off in (0, 10):
        for at, start, end in ((0.1, 0.2, 5.0), (5.5, 5.6, 6.6), (7.5, 7.6, 8.0),
                               (8.9, 9.0, 10.0)):
            corr += 1
            events += [launch(corr, at + off), kernel(corr, start + off, end + off)]
    ctx = SimpleNamespace(trace=Trace(events), units=2)
    assert seg_bwd_idle_ms.read(ctx) == pytest.approx(0.6 + 1.0 + 1.0, abs=1e-5)


@pytest.mark.parametrize("reader", [seg_fwd_ms, ds_loss_ms, seg_bwd_ms, vil_mixer_ms,
                                    seg_bwd_idle_ms, sgd_ms])
def test_a_program_without_the_spans_reads_none(reader):
    """A program older than the spans (this cell's parent) reads None."""
    events = [Event("train.step", 0, 10), launch(1, 1), kernel(1, 2, 3)]
    assert reader.read(SimpleNamespace(trace=Trace(events), units=1)) is None
    assert reader.read(SimpleNamespace(trace=None, units=1)) is None
