"""PyTorch port: checkpoints. The save policy of the JAX CheckpointManager
(latest always, the bests on improvement, None metrics leaving the bests, a
backup every backup_interval), a bitwise round trip of everything a train
state holds, and pretrained-weight surgery whose loaded and skipped names
are the JAX `surgical_restore`'s on the same two trees."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from xlstm_hved_tpu.engine.checkpoint import surgical_restore as jax_surgical_restore
from xlstm_hved_tpu.models import find_model_using_name as jax_model
from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.engine.checkpoint import CheckpointManager, surgical_restore
from xlstm_hved_torch.engine.train import create_train_state
from xlstm_hved_torch.models import Discriminator, find_model_using_name

S = 16


def _state(seed, name="XLSTM_HVED", **overrides):
    """A train state whose weights, BatchNorm statistics and both Adam
    states are all set (two optimizer steps on drawn gradients)."""
    model = find_model_using_name(name, device="cpu", **overrides)
    state = create_train_state(model, Discriminator(f_maps=8, kernel=3), TrainConfig(), seed,
                               torch.zeros(1, 4, S, S, S))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if "running_" in n:
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    for opt, module in ((state.opt_g, model), (state.opt_d, state.disc)):
        for _ in range(2):
            for p in module.parameters():
                p.grad = torch.randn(p.shape, generator=gen)
            opt.step()
            opt.zero_grad(set_to_none=True)
    state.step = 7 + seed
    return state


def test_save_epoch_policy_and_none_metrics(tmp_path):
    """As tests/test_engine.py::test_save_epoch_none_metrics_do_not_touch_bests,
    plus the backups and the meta files."""
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), backup_interval=2)
    state = _state(0)
    bv, bd = ckpt.save_epoch(state, 1, vloss=0.5, dice=0.7, best_vloss=float("inf"),
                             best_dice=0.0)
    assert (bv, bd) == (0.5, 0.7)
    assert ckpt.exists("best_vloss") and ckpt.exists("best_dice") and ckpt.exists("latest")
    assert os.path.isdir(ckpt._path("latest"))
    mtime_v = os.path.getmtime(os.path.join(ckpt._path("best_vloss"), "state.pt"))
    for epoch in (2, 3):   # no validation: the bests and their files stay
        bv, bd = ckpt.save_epoch(state, epoch, vloss=None, dice=None, best_vloss=bv,
                                 best_dice=bd)
    assert (bv, bd) == (0.5, 0.7)
    assert os.path.getmtime(os.path.join(ckpt._path("best_vloss"), "state.pt")) == mtime_v
    with open(ckpt._meta_path("latest")) as f:
        meta = json.load(f)
    assert meta == dict(epoch=3, vloss=None, dice=None, best_vloss=0.5, best_dice=0.7)
    assert ckpt.exists("backups/epoch2") and not ckpt.exists("backups/epoch3")
    bv, bd = ckpt.save_epoch(state, 4, vloss=0.6, dice=0.8, best_vloss=bv, best_dice=bd)
    assert (bv, bd) == (0.5, 0.8)    # only the dice improved
    with open(ckpt._meta_path("best_dice")) as f:
        assert json.load(f)["epoch"] == 4
    with open(ckpt._meta_path("best_vloss")) as f:
        assert json.load(f)["epoch"] == 1


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_round_trip_restores_the_whole_state_bitwise(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    fresh = _state(1)
    assert ckpt.load_or_initialize(fresh)[1:] == (1, float("inf"), 0.0)
    saved = _state(0)
    ckpt.save_epoch(saved, 5, vloss=0.3, dice=0.6, best_vloss=0.4, best_dice=0.5)
    state, epoch, bv, bd = ckpt.load_or_initialize(fresh)
    assert state is fresh and (epoch, bv, bd) == (6, 0.3, 0.6) and state.step == saved.step
    for part in ("model", "disc", "opt_g", "opt_d"):
        _assert_same(getattr(state, part).state_dict(), getattr(saved, part).state_dict())
    assert any("running_var" in n for n in state.model.state_dict())
    raw, meta = ckpt.restore_raw("latest")
    assert set(raw) == {"step", "model", "disc", "opt_g", "opt_d"} and meta["epoch"] == 5


def _jax_param_shapes(name, **overrides):
    model = jax_model(name, compute_dtype="float32", use_pallas_mlstm=False, **overrides)
    x = jnp.zeros((1, S, S, S, 4))
    shapes = jax.eval_shape(lambda: model.init(tp.RNGS, x, deterministic=True, recon=True))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])


_LEAF = {"kernel": "weight", "scale": "weight", "alpha": "weight"}


def _torch_name(keystr):
    """A flax leaf path, as jax.tree_util.keystr prints it, -> the port's
    parameter name (utils/convert.py's naming)."""
    keys = [k.strip("'") for k in keystr.strip("[]").split("][")]
    return ".".join(keys[:-1] + [_LEAF.get(keys[-1], keys[-1])])


@pytest.fixture(scope="module")
def jax_surgery():
    target = _jax_param_shapes("XLSTM_HVED")
    donor = _jax_param_shapes("U_HVEDDuSFEmViLDFNet3D", shared_recon=False)
    _, loaded, skipped = jax_surgical_restore(target, donor)
    return {_torch_name(k) for k in loaded}, {_torch_name(k) for k in skipped}


def test_surgical_restore_matches_jax_names(jax_surgery):
    donor = _state(2, "U_HVEDDuSFEmViLDFNet3D", shared_recon=False)
    target = _state(3)
    stats = {n: b.clone() for n, b in target.model.named_buffers()}
    donor_sd = donor.model.state_dict()
    loaded, skipped = surgical_restore(target.model, donor_sd, verbose=True)
    want_loaded, want_skipped = jax_surgery
    assert set(loaded) == want_loaded and set(skipped) == want_skipped
    assert {"rfinal_0.weight", "sfinal_0.weight", "final_conv.weight"} <= set(skipped)
    assert "rdecoder_0_0.basic.conv1.Conv3DFast_0.weight" in loaded
    params = dict(target.model.named_parameters())
    assert all(torch.equal(params[n], donor_sd[n]) for n in loaded)
    # parameters only: the running statistics are the target's own
    assert all(torch.equal(b, stats[n]) for n, b in target.model.named_buffers())
