"""PyTorch port: the pretrain slice against the JAX package on numpy-drawn
weights and inputs: the pretrain net's forward (a recon decoder per
modality, `shared_recon=False`) at 32^3, its weights carried strictly, the
pretrain objective's loss and raw gradients and one whole pretrain step at
16^3, the freeze mask, and SSIM / mean IoU.

The objective runs with the latent noise off on both sides: the port passes
deterministic=True, the JAX model's `reparametrize` is patched to return the
mean (as tests/test_torch_train.py does). Bounds: the forwards'
(tests/test_torch_hved.py: seg max 1e-3, recon max 3.5e-3) and the G step's
(tests/test_torch_train.py: LOSS_RTOL, GRAD_SCALED, GRAD_FLOOR).

The gradients are held against JAX's own objective run in float64
(`jax.enable_x64`, with the JAX modules' fp32 casts mapped to fp64 for that
trace only), under the G step's bounds. JAX's fp32 CPU gradient is not the
witness: on these weights at 16^3 it is up to 1.1e-2 (per tensor, relative
L2; 2.4e-3 over all tensors) off JAX's fp64 one, where the port's fp32
gradient is within 3.3e-4 (1.2e-5) of it; the test prints both distances
(`pytest -s`). JAX fp32 is still held to its fp64 run at about twice that
measured distance (JAX_GRAD_REL, JAX_GRAD_GLOBAL), so the two JAX runs are
shown to be the same function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
import xlstm_hved_tpu.models.hved as jax_hved
from xlstm_hved_tpu import losses as jl
from xlstm_hved_tpu import metrics as jm
from xlstm_hved_tpu.config import TrainConfig as JaxTrainConfig
from xlstm_hved_tpu.config import get_config as jax_get_config
from xlstm_hved_tpu.engine import train as jtrain
from xlstm_hved_tpu.models import uxlstm as juxlstm
from xlstm_hved_tpu.nn import blocks as jblocks
from xlstm_hved_tpu.nn import vil as jvil
from xlstm_hved_tpu.ops import mlstm as jmlstm
from xlstm_hved_tpu.utils.subsets import SUBSET_MASKS
from xlstm_hved_torch import metrics as tmet
from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.engine import train as ttrain
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.utils.convert import _flatten, _param, params_from_jax

NAME = "U_HVEDDuSFEmViLDFNet3D"
S = 16
KEEP = np.array([False, True, True, False])
# tests/test_torch_train.py's G-step bounds
GRAD_SCALED, GRAD_FLOOR = 2e-3, 2e-5
LOSS_RTOL = 1e-4
# JAX fp32 against JAX fp64: relative L2 error per tensor (the denominator
# floored at 1e-3 of the largest gradient) and over all tensors; see the
# module docstring
JAX_GRAD_REL, JAX_GRAD_GLOBAL = 2.5e-2, 5e-3
# the JAX modules whose fp32 casts become fp64 for the float64 trace
_JAX_F32_MODULES = (jax_hved, juxlstm, jmlstm, jvil, jblocks, jl)


class _F64Numpy:
    """`jax.numpy` with `float32` read as `float64`."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_net():
    return jax_hved.HVEDFusionNet(jax_get_config(NAME, shared_recon=False,
                                                 compute_dtype="float32",
                                                 use_pallas_mlstm=False))


def _port_net(variables):
    model = find_model_using_name(NAME, device="cpu", shared_recon=False)
    model.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model.eval()


# ------------------------------------------------------------------ the forward at 32^3

@pytest.fixture(scope="module")
def net32():
    jmodel = _jax_net()
    x = np.random.RandomState(42).rand(1, 32, 32, 32, 4).astype(np.float32)
    variables = tp.random_variables(jmodel, jnp.asarray(x), seed=3, deterministic=True,
                                    recon=True)
    fwd = jax.jit(lambda v, x, keep, seg: jmodel.apply(v, x, keep=keep, seg=seg, recon=True,
                                                       deterministic=True),
                  static_argnames="seg")
    return _port_net(variables), fwd, tp.to_jax(variables), x


def test_per_modality_recon_tree_loads_strictly(net32):
    model = net32[0]
    names = {n for n, _ in model.named_parameters()}
    assert {f"rdecoder_{m}_2.basic.conv1.Conv3DFast_0.weight" for m in range(4)} <= names
    assert model.rfinal_3.weight.shape == (1, 4, 1, 1, 1)
    assert model.sfinal_0.weight.shape == (1, 4, 1, 1, 1)
    assert model.final_conv.weight.shape == (3, 1, 1, 1, 1)


@pytest.mark.parametrize("subset,seg", [(14, True), (5, True), (14, False), (2, False)])
def test_per_modality_recon_forward_matches_jax(net32, subset, seg):
    model, fwd, jvars, x = net32
    keep = SUBSET_MASKS[subset]
    with torch.no_grad():
        out = model(tp.ncdhw(x), keep=torch.tensor(keep), seg=seg, recon=True,
                    deterministic=True)
    ref = fwd(jvars, jnp.asarray(x), jnp.asarray(keep), seg)
    assert out.recon.shape == (1, 4, 32, 32, 32)
    assert tp.max_abs(tp.ndhwc(out.recon), ref.recon) < 3.5e-3
    if seg:
        assert out.seg.shape == (1, 3, 32, 32, 32)
        assert tp.max_abs(tp.ndhwc(out.seg), ref.seg) < 1e-3
    else:
        assert out.seg is None and ref.seg is None


# ------------------------------------------------------------------ the objective and the step at 16^3

@pytest.fixture(scope="module")
def pretrain():
    """The JAX pretrain objective (engine/train.py's make_pretrain_step
    loss) and one JAX pretrain step, with the port's on the same weights."""
    cfg_j, cfg_t = JaxTrainConfig(crop_size=(S,) * 3), TrainConfig(crop_size=(S,) * 3)
    jmodel = _jax_net()
    x = np.random.RandomState(9).rand(1, S, S, S, 4).astype(np.float32)
    variables = tp.random_variables(jmodel, jnp.asarray(x), seed=10, deterministic=True,
                                    recon=True)
    jv = tp.to_jax(variables)
    freeze = jtrain.freeze_mask_for(jv["params"], ("sdecoder",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hved, "reparametrize", lambda key, mu, lv, deterministic=False: mu)

        def loss_fn(params_g, batch_stats, x, keep):   # make_pretrain_step's loss
            out_m = jmodel.apply({"params": params_g, "batch_stats": batch_stats}, x,
                                 keep=keep, seg=False, recon=True, train=False,
                                 rngs={"latent": jax.random.PRNGKey(1)})
            recon = jl.l2_loss(out_m.recon, x)
            kld = jnp.mean(jnp.stack([jl.compute_kld_subsets(mu, lv, keep[None, :])
                                      for mu, lv in zip(out_m.mu, out_m.logvar)]))
            return recon + cfg_j.weight_vae * kld, (recon, kld)

        (jloss, (jrecon, jkld)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jv["params"], jv["batch_stats"], jnp.asarray(x), jnp.asarray(KEEP))
        tx = jtrain.make_optimizer(cfg_j, 1)
        state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=jv["params"],
                                  batch_stats_g=jv["batch_stats"],
                                  opt_state_g=tx.init(jv["params"]), params_d={},
                                  opt_state_d=None)
        step = jtrain.make_pretrain_step(jmodel, cfg_j, 1, freeze_mask=freeze)
        new_state, _ = step(state, jnp.asarray(x), jax.random.PRNGKey(3))
        with jax.enable_x64(True):   # the same objective, traced in float64
            for module in _JAX_F32_MODULES:
                mp.setattr(module, "jnp", _F64Numpy())
            f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
            (_, (recon64, _)), grads64 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                f64(variables["params"]), f64(variables["batch_stats"]),
                jnp.asarray(x, jnp.float64), jnp.asarray(KEEP))
            assert recon64.dtype == jnp.float64
            grads64 = jax.tree.map(lambda g: np.asarray(g, np.float64), grads64)
    before = params_from_jax(variables["params"])
    after = params_from_jax(jax.device_get(new_state.params_g))
    return dict(cfg=cfg_t, variables=variables, x=x, freeze=freeze,
                jax=dict(loss=float(jloss), recon=float(jrecon), kld=float(jkld),
                         grads=params_from_jax(jax.device_get(jgrads)),
                         grads64=_grads_f64(grads64),
                         moved={n for n in before if not torch.equal(before[n], after[n])}))


def _grads_f64(grads):
    """JAX float64 gradients under the port's names and layouts, kept in float64."""
    return {key: torch.from_numpy(np.ascontiguousarray(leaf))
            for key, leaf in (_param(path, g) for path, g in _flatten(grads).items())}


def _pretrain_grads(model, fx, dtype):
    loss, terms = ttrain.pretrain_objective(model, fx["cfg"])(
        tp.ncdhw(fx["x"]).to(dtype), torch.from_numpy(KEEP), deterministic=True)
    names, params = zip(*model.named_parameters())
    return terms, dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))


def test_pretrain_loss_and_gradients_match_jax(pretrain):
    want = pretrain["jax"]
    terms, got = _pretrain_grads(_port_net(pretrain["variables"]), pretrain, torch.float32)
    for name in ("loss", "recon", "kld"):
        np.testing.assert_allclose(float(terms[name]), want[name], rtol=LOSS_RTOL, err_msg=name)
    exact = want["grads64"]
    assert set(got) == set(want["grads"]) == set(exact)
    assert got["sfinal_0.weight"] is None
    assert got["rdecoder_3_0.basic.conv1.Conv3DFast_0.weight"] is not None
    used = [n for n, g in got.items() if g is not None]
    for name in set(got) - set(used):  # out of the seg-free graph: JAX's is exactly zero
        assert not want["grads"][name].any() and not exact[name].any(), name
    top = max(float(exact[n].abs().max()) for n in used)
    for name in used:   # the G step's bounds against JAX's float64 gradient
        err = float((got[name].double() - exact[name]).abs().max())
        assert err <= GRAD_SCALED * float(exact[name].abs().max()) + GRAD_FLOOR * top, name
    rel = lambda g, n: (float((g[n].double() - exact[n]).norm())
                        / max(float(exact[n].norm()), 1e-3 * top))
    flat = lambda g: torch.cat([g[n].double().flatten() for n in used])
    whole = lambda g: float((flat(g) - flat(exact)).norm() / flat(exact).norm())
    for name in used:   # JAX fp32 against JAX fp64
        assert rel(want["grads"], name) <= JAX_GRAD_REL, (name, rel(want["grads"], name))
    assert whole(want["grads"]) <= JAX_GRAD_GLOBAL
    for label, g in (("port fp32", got), ("JAX fp32", want["grads"])):
        print(f"{label} against JAX fp64: relative L2 error per tensor at most "
              f"{max(rel(g, n) for n in used):.3e}, over all tensors {whole(g):.3e}")


def test_pretrain_step_freezes_and_moves_as_jax(pretrain):
    model = _port_net(pretrain["variables"])
    cfg = pretrain["cfg"]
    x = tp.ncdhw(pretrain["x"])
    state = ttrain.create_train_state(model, Discriminator(f_maps=8, kernel=3), cfg, 0, x)
    model.load_state_dict(params_from_jax(pretrain["variables"]["params"],
                                          pretrain["variables"]["batch_stats"]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    freeze = ttrain.freeze_mask_for(model, ("sdecoder",))
    step = ttrain.make_pretrain_step(model, cfg, freeze_mask=freeze)
    state, metrics = step(state, x)
    assert state.step == 1 and set(metrics) == {"loss", "recon", "kld"}
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved == pretrain["jax"]["moved"]
    assert not any(freeze[k] == 0.0 for k in moved)
    assert not any("running_" in k or "num_batches" in k for k in moved)
    assert "sfinal_0.weight" in moved   # no gradient, but the weight decay moves it


def test_freeze_mask_matches_jax(pretrain):
    params = pretrain["variables"]["params"]
    jmask = jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                         pretrain["freeze"], params)
    want = {k: float(v.flatten()[0]) for k, v in params_from_jax(jmask).items()}
    got = ttrain.freeze_mask_for(_port_net(pretrain["variables"]), ("sdecoder",))
    assert got == want
    assert sum(v == 0.0 for v in got.values()) == sum("sdecoder" in k for k in got) > 0


# ------------------------------------------------------------------ metrics

def test_ssim3d_and_mean_iou_match_jax():
    rng = np.random.RandomState(11)
    p = rng.rand(2, 12, 14, 13, 4).astype(np.float32)
    t = np.clip(p + 0.1 * rng.randn(*p.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tmet.ssim3d(tp.ncdhw(p), tp.ncdhw(t))),
                               float(jm.ssim3d(jnp.asarray(p), jnp.asarray(t))), rtol=1e-5)
    for c in (1, 3):
        pred = np.ascontiguousarray(p[:, :8, :8, :8, :c])
        target = (rng.rand(2, 8, 8, 8, c) > 0.5).astype(np.float32)
        np.testing.assert_allclose(float(tmet.mean_iou(tp.ncdhw(pred), tp.ncdhw(target))),
                                   float(jm.mean_iou(jnp.asarray(pred), jnp.asarray(target))),
                                   rtol=1e-6)
