"""PyTorch port: stage remat (`HVEDConfig.remat`, the CLIs' --remat) and
checkpoints across compute dtypes, on the CPU at 16^3.

With remat the stages the JAX model wraps in `nn.remat`
(BlockDiagEncoderStage, EncoderStage, DecoderStage, BlockDiagSingleConv)
run as `torch.utils.checkpoint` while gradients are taken: the G gradients
and the BatchNorm running statistics equal those without it bit for bit,
and the parameter names do not change. None of the four stage types holds a
BatchNorm, whose train-mode statistics a recompute would move twice; a
DropPath with a non-zero rate inside a stage is refused (its draw comes from
an explicit generator, which the recompute would draw again). Checkpoints
hold fp32 parameters whatever the compute dtype and load across dtypes and
remat; the hoisted sweep equals the plain one bit for bit in bf16 too.
"""
import os

import pytest
import torch

import xlstm_hved_torch.models.hved as thved
from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.engine import train as ttrain
from xlstm_hved_torch.engine.checkpoint import CheckpointManager
from xlstm_hved_torch.engine.evaluate import (default_apply_fn, make_hoisted_subset_sweep,
                                              make_subset_sweep)
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.nn.blocks import BatchNorm3d
from xlstm_hved_torch.nn.vil import DropPath
from xlstm_hved_torch.utils.subsets import subset_mask

S = 16
CFG = TrainConfig(crop_size=(S,) * 3)
# stage calls of one XLSTM_HVED forward with seg and recon: encoders and DRBs
# of 4 levels, 3 skr encoders, 3 seg and 3 recon decoder stages
FLAGSHIP_STAGES = 4 + 4 + 3 + 3 + 3


def _inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(1, 4, S, S, S, generator=gen)
    mask = (torch.rand(1, 3, S, S, S, generator=gen) > 0.7).float()
    return x, mask


def _pair(name="XLSTM_HVED", **kw):
    """(model, remat model) with the same weights, and a D."""
    model = find_model_using_name(name, device="cpu", seed=1, **kw)
    remat = find_model_using_name(name, device="cpu", seed=2, remat=True, **kw)
    disc = Discriminator(f_maps=8, kernel=3, dtype=remat.dtype)
    ttrain.create_train_state(model, disc, CFG, 0, _inputs()[0], init_scheme="reference")
    remat.load_state_dict(model.state_dict(), strict=True)
    return model, remat, disc


def _g_grads(model, disc, x, mask):
    """The G objective's gradients and the running statistics it leaves."""
    disc.requires_grad_(False)
    loss, _ = ttrain._g_objective(model, disc, CFG)(x, mask, subset_mask(6, "cpu"),
                                                    deterministic=True)
    disc.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    return loss, grads, {n: b.clone() for n, b in model.named_buffers()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_g_gradients_and_running_stats_equal(dtype, monkeypatch):
    model, remat, disc = _pair(compute_dtype=dtype)
    assert list(model.state_dict()) == list(remat.state_dict())
    calls = []
    monkeypatch.setattr(thved, "checkpoint",
                        lambda *a, **kw: calls.append(1) or torch.utils.checkpoint.checkpoint(
                            *a, **kw))
    x, mask = _inputs()
    loss, grads, stats = _g_grads(model, disc, x, mask)
    assert not calls
    loss_r, grads_r, stats_r = _g_grads(remat, disc, x, mask)
    assert len(calls) == 2 * FLAGSHIP_STAGES   # the objective's two G forwards
    assert torch.equal(loss, loss_r)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and torch.equal(g, grads_r[name]), name
    moved = [n for n, b in stats.items() if "running_" in n]
    assert moved and all(torch.equal(stats[n], stats_r[n]) for n in stats)


def test_remat_pretrain_gradients_equal():
    """The pretrain objective: eval-mode BatchNorm, gradients through it."""
    model, remat, _ = _pair(shared_recon=False)
    x, _ = _inputs(1)
    keep = subset_mask(3, "cpu")
    grads = []
    for net in (model, remat):
        loss, _ = ttrain.pretrain_objective(net, CFG)(x, keep, deterministic=True)
        names, params = zip(*net.named_parameters())
        grads.append(dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True))))
    for name, g in grads[0].items():
        assert (g is None) == (grads[1][name] is None), name
        assert g is None or torch.equal(g, grads[1][name]), name


def test_remat_only_while_gradients_are_taken(monkeypatch):
    _, remat, _ = _pair()
    calls = []
    monkeypatch.setattr(thved, "checkpoint", lambda *a, **kw: calls.append(1))
    with torch.no_grad():
        out = remat(_inputs()[0], recon=True, deterministic=True)
    assert not calls and torch.isfinite(out.seg).all()


@pytest.mark.parametrize("name", ["XLSTM_HVED", "U_HVEDConvXLSTMNet3D"])
def test_remat_stages_hold_no_batchnorm(name):
    """A train-mode BatchNorm inside a rematerialised stage would move its
    running statistics in the recompute as well."""
    model = find_model_using_name(name, device="cpu", remat=True)
    stages = [m for m in model.modules() if isinstance(m, thved.REMAT_STAGES)]
    assert len(stages) >= 14
    for stage in stages:
        assert not any(isinstance(m, (BatchNorm3d, torch.nn.modules.batchnorm._BatchNorm))
                       for m in stage.modules()), type(stage).__name__


def test_remat_refuses_a_drawing_droppath():
    """U_HVEDConvXLSTMNet3D's seg decoder stage 0 holds a ViL with a DropPath
    (rate 0 in every preset): with a non-zero rate remat is refused; at rate
    0 the gradients equal those without remat."""
    model, remat, disc = _pair("U_HVEDConvXLSTMNet3D")
    x, mask = _inputs(2)
    _, grads, _ = _g_grads(model, disc, x, mask)
    _, grads_r, _ = _g_grads(remat, disc, x, mask)
    assert all(torch.equal(g, grads_r[n]) for n, g in grads.items())
    drop = [m for m in remat.sdecoder_0.modules() if isinstance(m, DropPath)]
    assert len(drop) == 1
    drop[0].rate = 0.1
    with pytest.raises(NotImplementedError, match="DropPath"):
        _g_grads(remat, disc, x, mask)


@pytest.mark.parametrize("src,dst", [({"compute_dtype": "bfloat16"}, {}),
                                     ({}, {"compute_dtype": "bfloat16"}),
                                     ({"compute_dtype": "bfloat16", "remat": True}, {})],
                         ids=["bf16-to-fp32", "fp32-to-bf16", "bf16-remat-to-fp32"])
def test_checkpoints_load_across_dtypes_and_remat(src, dst, tmp_path):
    model = find_model_using_name("XLSTM_HVED", device="cpu", **src)
    disc = Discriminator(f_maps=8, kernel=3, dtype=model.dtype)
    x, mask = _inputs(3)
    state = ttrain.create_train_state(model, disc, CFG, 0, x)
    state, _ = ttrain.make_train_step(model, disc, CFG)(state, x, mask)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_epoch(state, 1, 0.5, 0.5, float("inf"), 0.0)
    raw = ckpt.restore_raw("latest")[0]
    assert all(t.dtype in (torch.float32, torch.int64) for t in raw["model"].values())
    target = find_model_using_name("XLSTM_HVED", device="cpu", seed=5, **dst)
    target.load_state_dict(raw["model"], strict=True)
    for name, t in target.state_dict().items():
        assert torch.equal(t, model.state_dict()[name]), name
    # the whole train state resumes into a model of the other dtype
    target_disc = Discriminator(f_maps=8, kernel=3, dtype=target.dtype)
    resumed = ttrain.create_train_state(target, target_disc, CFG, 1, x)
    resumed, epoch, _, _ = ckpt.load_or_initialize(resumed)
    assert epoch == 2 and resumed.step == 1
    assert os.path.exists(tmp_path / "latest" / "state.pt")


@pytest.mark.parametrize("name", ["XLSTM_HVED", "U_HVEDConvXLSTMNet3D"])
def test_hoisted_sweep_equals_plain_in_bf16(name):
    model = find_model_using_name(name, device="cpu", compute_dtype="bfloat16", seed=4)
    x = torch.rand(1, 4, S, S, S, generator=torch.Generator().manual_seed(5))
    crop = (S,) * 3
    seg_h, rec_h = make_hoisted_subset_sweep(model, crop, crop, recon_channels=4)(model, x)
    seg_p, rec_p = make_subset_sweep(default_apply_fn(model, recon=True), crop, crop,
                                     recon_channels=4)(model, x)
    assert seg_h.dtype == torch.float32 and torch.equal(seg_h, seg_p)
    assert torch.equal(rec_h, rec_p)
