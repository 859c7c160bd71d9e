"""PyTorch port: the deep-supervised SGD step of `engine/seg_train.py` on
UXlstmEnc 3-D against the plain reference `tests/_plain_uxlstm.py` (no JAX,
nothing of the port), on the CPU.

The small plan: 32^3, 5 stages of 4 .. 64 features, so stage 3 (4^3 voxels,
32 channels) is a ViL over patch tokens and stage 4 (2^3 voxels, 64
channels) one over channel tokens; 4 heads with deep supervision, batch 2.

Tolerances, with their reasons:
- fp64 (the port runs in fp64 when its parameters are, nothing cast): the
  same mathematics on both sides, so every head, the loss, every gradient
  and the parameters after 2 steps agree to 1e-9, far above fp64's
  rounding and far below any difference in the formulas;
- fp32, against the reference in fp64: this net's fp32 gradient is
  ill-conditioned at random weights (instance norms over 8 voxels at 2^3):
  the port's fp32 gradient lies 0.5 % (relative L2) from its own fp64
  gradient, so the gradient is held at 3 %, and the change of the
  parameters over 2 steps, which carries the first step's rounding into the
  second gradient (measured 5 %), at 20 %; the heads at 1e-4 of their
  largest value and the loss at 1e-5 (measured 2e-5 and 1.4e-7);
- bf16 (convs at the op, the ViL fp32), two steps on one batch against the
  fp64 reference: the first loss within 1e-2 (read 8e-4 on two batches) and
  the loss's decrease from the first step to the second, which the first
  update makes, within 25 % (read 7 % and 13 %). The parameters' own change
  cannot be held here: at this size the first stages' bf16 gradient is
  mostly rounding. Plain momentum in place of Nesterov halves the first
  update (the decrease reads 45-47 % off), a dropped 1/2-scale head takes a
  quarter of the loss away (26 %).
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch

import _plain_uxlstm as plain
from xlstm_hved_torch.engine import seg_train as st
from xlstm_hved_torch.models import build_uxlstm_from_plans

PLAN = {"patch_size": [32, 32, 32], "conv_kernel_sizes": [[3, 3, 3]] * 5,
        "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 4,
        "n_conv_per_stage_encoder": [2] * 5, "n_conv_per_stage_decoder": [2] * 4,
        "UNet_base_num_features": 4, "unet_max_num_features": 64}
BRATS_POOLS = [[1, 1, 1]] + [[2, 2, 2]] * 5
SCALES = st.deep_supervision_scales(PLAN["pool_op_kernel_sizes"])
# dtype -> (heads, loss, gradients, change over 2 steps)
TOL = {torch.float64: (1e-9, 1e-9, 1e-9, 1e-9), torch.float32: (1e-4, 1e-5, 3e-2, 0.2)}
BF16_LOSS, BF16_DECREASE = 1e-2, 0.25


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_net(dtype=None, head_scale=1.0):
    """The port's net on the small plan, its own initialisation from seed 0;
    `head_scale` scales the heads' weights and biases (30: logits 30 times
    larger, and a gradient norm of 31, so that the clip at 12 binds)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = build_uxlstm_from_plans(PLAN, 4, 3, True,
                                      dtype=torch.bfloat16 if dtype == torch.bfloat16 else None)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if ".seg" in name:
                p.mul_(head_scale)
    return net.double() if dtype == torch.float64 else net


def batch(seed):
    """x (2, 4, 32^3) in [0, 1) and nested WT / TC / ET region masks."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(2, 4, 32, 32, 32, generator=g)
    field = torch.rand(2, 1, 32, 32, 32, generator=g)
    return x, torch.cat([field < 0.6, field < 0.3, field < 0.1], dim=1).float()


def rel_l2(got, want):
    num = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    return math.sqrt(num / sum(float(w.double().square().sum()) for w in want))


def run_port(net, dtype, seeds=(1, 2), opt=None):
    """(losses, parameters after the steps) of the port's step, one step on
    each seed's batch."""
    cfg = st.SegTrainConfig()
    state = st.SegTrainState(net, opt or st.make_sgd(net.parameters(), cfg))
    step = st.make_ds_train_step(net, cfg)
    losses = []
    for seed in seeds:
        x, regions = batch(seed)
        cast = torch.float64 if dtype == torch.float64 else torch.float32
        state, loss = step(state, x.to(cast), st.deep_supervision_targets(regions.to(cast), SCALES))
        losses.append(float(loss))
    return losses, {n: p.detach().double() for n, p in net.named_parameters()}


def run_reference(state, seeds=(1, 2)):
    ref = plain.build(PLAN, 4, 3, state, torch.float64)
    step = plain.Step(ref)
    losses, norms = [], []
    for seed in seeds:
        x, regions = batch(seed)
        loss, norm = step(x.double(), plain.ds_targets(regions.double(), SCALES))
        losses.append(float(loss))
        norms.append(norm)
    return losses, norms, dict(ref.named_parameters())


@pytest.mark.parametrize("dtype,clip", [(torch.float64, "free"), (torch.float64, "binds"),
                                        (torch.float32, "free")])
def test_ds_step_matches_the_plain_reference(dtype, clip):
    """Every head's logits, the loss, every parameter's gradient (and which
    have none: the lowest head, of weight 0), and the parameters after 2
    SGD steps, with the clip at 12 binding or not."""
    tol_h, tol_l, tol_g, tol_c = TOL[dtype]
    net = port_net(dtype, 30.0 if clip == "binds" else 1.0)
    w0 = {n: p.detach().double().clone() for n, p in net.named_parameters()}
    ref = plain.build(PLAN, 4, 3, net.state_dict(), torch.float64)

    x, regions = batch(1)
    heads = net(x.to(dtype))
    ref_loss, ref_grads, want = plain.Step(ref).gradients(
        x.double(), plain.ds_targets(regions.double(), SCALES))
    assert len(heads) == len(want) == 4
    for h, r in zip(heads, want):
        assert float((h.detach().double() - r).abs().max()) <= tol_h * float(r.abs().max())
    loss = st.deep_supervision_loss(heads, st.deep_supervision_targets(regions.to(dtype), SCALES))
    assert abs(float(loss) - float(ref_loss)) <= tol_l * abs(float(ref_loss))
    loss.backward()
    names = [n for n, _ in ref.named_parameters()]
    params = dict(net.named_parameters())
    assert [n for n, g in zip(names, ref_grads) if g is None] == \
        [n for n in names if params[n].grad is None] == ["decoder.seg1.weight", "decoder.seg1.bias"]
    pairs = [(params[n].grad, g) for n, g in zip(names, ref_grads) if g is not None]
    assert rel_l2(*zip(*pairs)) <= tol_g
    net.zero_grad(set_to_none=True)

    losses, after = run_port(net, dtype)
    ref_losses, norms, ref_after = run_reference({n: w0[n] for n in w0})
    assert (norms[0] > 12.0) == (clip == "binds"), norms
    for got, want in zip(losses, ref_losses):
        assert abs(got - want) <= tol_l * abs(want)
    assert rel_l2([after[n] - w0[n] for n in names],
                  [ref_after[n].detach() - w0[n] for n in names]) <= tol_c


def test_brats_plan_deep_supervision_weights_and_scales():
    """nnU-Net's 3d_fullres BraTS plan: five heads at 1, 1/2 .. 1/16 (the
    sixth stage's scale left out), weighted [1, 1/2, 1/4, 1/8, 0] / 1.875."""
    assert st.deep_supervision_scales(BRATS_POOLS) == [
        (1.0,) * 3, (0.5,) * 3, (0.25,) * 3, (0.125,) * 3, (0.0625,) * 3]
    assert st.deep_supervision_weights(5) == [v / 1.875 for v in (1.0, 0.5, 0.25, 0.125, 0.0)]
    assert plain.ds_scales(BRATS_POOLS) == st.deep_supervision_scales(BRATS_POOLS)


def _dropped_head(n, weights=st.deep_supervision_weights):
    """The deep-supervision weights with the 1/2-scale head's set to 0."""
    out = weights(n)
    out[1] = 0.0
    return out


@pytest.mark.parametrize("fault", [None, "plain_momentum", "dropped_head"])
def test_bf16_step_stays_near_the_reference(monkeypatch, fault):
    """The bf16 step against the fp64 reference over 2 steps on one batch:
    within bound; with plain momentum in place of Nesterov, or the
    1/2-scale head's weight dropped, past it."""
    net = port_net(torch.bfloat16)
    w0 = {n: p.detach().double().clone() for n, p in net.named_parameters()}
    opt = None
    if fault == "plain_momentum":
        cfg = st.SegTrainConfig()
        opt = torch.optim.SGD(net.parameters(), lr=cfg.learning_rate, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
    elif fault == "dropped_head":
        monkeypatch.setattr(st, "deep_supervision_weights", _dropped_head)
    losses, _ = run_port(net, torch.bfloat16, (1, 1), opt)
    ref_losses, _, _ = run_reference(w0, (1, 1))
    loss_gap = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    decrease, ref_decrease = losses[0] - losses[1], ref_losses[0] - ref_losses[1]
    decrease_gap = abs(decrease - ref_decrease) / abs(ref_decrease)
    within = loss_gap <= BF16_LOSS and decrease_gap <= BF16_DECREASE
    assert within == (fault is None), (loss_gap, decrease_gap)


def test_one_step_records_each_span():
    """Under a recording profiler one step opens each `segtrain.*` span once
    and `vil.mixer` once per ViL stage (2)."""
    from torch.profiler import ProfilerActivity, profile

    net = port_net(torch.float32)
    x, regions = batch(1)
    cfg = st.SegTrainConfig()
    state = st.SegTrainState(net, st.make_sgd(net.parameters(), cfg))
    step = st.make_ds_train_step(net, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, x, st.deep_supervision_targets(regions, SCALES))
    names = [e.name for e in prof.events()]
    counts = {n: names.count(n) for n in ("segtrain.step", "segtrain.forward", "segtrain.loss",
                                           "segtrain.backward", "segtrain.sgd", "vil.mixer")}
    assert counts == {"segtrain.step": 1, "segtrain.forward": 1, "segtrain.loss": 1,
                      "segtrain.backward": 1, "segtrain.sgd": 1, "vil.mixer": 2}, counts


def _bench_builder():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import json

    from perfbench.drivers import uxlstm

    root = Path(__file__).resolve().parents[1]
    return uxlstm, json.loads((root / "perfbench/configs/uxlstm_enc_3d.json").read_text())


@pytest.mark.parametrize("field,value", [
    ("features_per_stage", [32, 64, 128, 256, 320, 512]),
    ("mixers", ["conv", "conv", "vil", "vil", "vil", "vil"]),
    ("channel_token", [False] * 6),
    ("vil_chunk_size", 64),
])
def test_benchmark_builder_refuses_a_contradicted_field(field, value):
    uxlstm, config = _bench_builder()
    uxlstm.program_config(config["model"])
    with pytest.raises(ValueError, match=field):
        uxlstm.program_config(dict(config["model"], **{field: value}))


def test_benchmark_builder_gives_the_three_wide_vil_sites():
    uxlstm, config = _bench_builder()
    traffic = {"patch": [128, 128, 128], "batch": 2}
    assert uxlstm.vil_sites(config["model"], traffic) == [
        (8, 4096, 128, 128), (8, 512, 160, 128), (8, 320, 32, 128)]
