"""PyTorch port: the training slice against the JAX package on numpy-drawn
inputs and weights: KL terms, losses, metrics, the discriminator, train-mode
BatchNorm, the generator loss and gradients of one G step, the D loss and
gradients, the optimizer, the samplers and the init schemes.

The G comparison runs both packages at 16^3 (XLSTM_HVED, f_maps 4, four
levels; D with kernel 3 and f_maps 8, as tests/test_engine.py) with the
latent noise off on both sides: the port passes deterministic=True, the JAX
model's `reparametrize` is patched to return the mean (its noise comes from
another generator). One module-scoped JAX value_and_grad serves every
G-gradient test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import _torch_port as tp
import xlstm_hved_tpu.models.hved as jax_hved
from xlstm_hved_tpu import losses as jl
from xlstm_hved_tpu import metrics as jm
from xlstm_hved_tpu.config import TrainConfig as JaxTrainConfig
from xlstm_hved_tpu.engine import train as jtrain
from xlstm_hved_tpu.nn.init_schemes import reference_init as jax_reference_init
from xlstm_hved_tpu.ops import poe as jpoe
from xlstm_hved_tpu.utils.subsets import SUBSET_MASKS
from xlstm_hved_torch import losses as tl
from xlstm_hved_torch import metrics as tmet
from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.engine import train as ttrain
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.nn.blocks import BatchNorm3d
from xlstm_hved_torch.nn.init_schemes import default_init, reference_init
from xlstm_hved_torch.ops import poe as tpoe
from xlstm_hved_torch.utils import subsets as tsub
from xlstm_hved_torch.utils.convert import params_from_jax

S = 16
KEEP = np.array([True, False, True, False])   # a drawn subset, passed to both
# fp32 sums in another order, amplified through the stacked InstanceNorms:
# every gradient tensor agrees to max|d| <= GRAD_SCALED * max|ref| +
# GRAD_FLOOR * (the largest gradient of the network). The floor is for the
# gradients that vanish analytically and are fp32 noise on both sides (a
# conv bias or BatchNorm scale right ahead of an InstanceNorm): measured
# up to 5e-6 of a 0.7 largest gradient, where real gradients agree to 2e-3.
GRAD_SCALED, GRAD_FLOOR = 2e-3, 2e-5
LOSS_RTOL = 1e-4   # the losses are fp32 means over 4k-25k values


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ KL, losses, metrics

def _experts(rng, B=2, C=3):
    mu = rng.randn(B, 5, S // 4, S // 4, S // 4, C).astype(np.float32)
    lv = (0.5 * rng.randn(*mu.shape)).astype(np.float32)
    mu[:, 0], lv[:, 0] = 0.0, 0.0
    to_port = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 2)))
    return (mu, lv), (to_port(mu), to_port(lv))


def test_kl_terms_match_jax():
    rng = np.random.RandomState(0)
    (mu, lv), (tmu, tlv) = _experts(rng)
    _close(tpoe.kl_divergence(tmu, tlv), jpoe.kl_divergence(mu, lv))
    _close(tpoe.kl_divergence(tmu, tlv, tmu * 0.5, tlv + 0.1),
           jpoe.kl_divergence(mu, lv, mu * 0.5, lv + 0.1))
    keeps = SUBSET_MASKS[[0, 6, 13]]
    _close(tpoe.compute_kld_subsets(tmu, tlv, torch.from_numpy(keeps)),
           jpoe.compute_kld_subsets(mu, lv, jnp.asarray(keeps)))
    drop = np.array([[True, False, True, True], [False, False, False, False]])
    _close(tpoe.compute_kld_drop(tmu, tlv, torch.from_numpy(drop)),
           jpoe.compute_kld_drop(mu, lv, jnp.asarray(drop)))


def _volumes(seed, C=3):
    rng = np.random.RandomState(seed)
    pred = rng.rand(2, S, S, S, C).astype(np.float32)
    target = (rng.rand(2, S, S, S, C) > 0.6).astype(np.float32)
    return pred, target


LOSSES = {
    "per_channel_dice": lambda m, p, t: m.per_channel_dice(p, t),
    "dice_loss": lambda m, p, t: m.dice_loss(p, t),
    "generalized_dice_loss": lambda m, p, t: m.generalized_dice_loss(p, t),
    "generalized_dice_loss_one_channel":
        lambda m, p, t: m.generalized_dice_loss(p[..., :1] if m is jl else p[:, :1],
                                                t[..., :1] if m is jl else t[:, :1]),
    "gan_loss_lsgan_real": lambda m, p, t: m.gan_loss_lsgan(p, True),
    "gan_loss_lsgan_fake": lambda m, p, t: m.gan_loss_lsgan(p, False),
    "boundary_loss": lambda m, p, t: m.boundary_loss(p, t - 0.5),
    "bce_loss": lambda m, p, t: m.bce_loss(p, t),
    "weighted_cross_entropy_loss": lambda m, p, t: m.weighted_cross_entropy_loss(p, t),
    "l2_loss": lambda m, p, t: m.l2_loss(p, t),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    pred, target = _volumes(1)
    if name == "weighted_cross_entropy_loss":  # one-hot targets
        target = np.eye(3, dtype=np.float32)[np.random.RandomState(2).randint(0, 3, pred.shape[:-1])]
    want = LOSSES[name](jl, jnp.asarray(pred), jnp.asarray(target))
    got = LOSSES[name](tl, tp.ncdhw(pred), tp.ncdhw(target))
    _close(got, want, rtol=1e-4)  # fp32 sums over 24k values in another order


def test_metrics_match_jax():
    pred, target = _volumes(3)
    tp_, tt = tp.ncdhw(pred), tp.ncdhw(target)
    _close(tmet.dice_coefficient(tp_, tt), jm.dice_coefficient(pred, target))
    for region in ("WT", "TC", "EC", "ET"):
        _close(tmet.dice_region(tp_, tt, region), jm.dice_region(pred, target, region))
    labels = np.random.RandomState(4).rand(2, S, S, S, 4).astype(np.float32)
    for region in ("WT", "TC", "EC"):
        _close(tmet.dice_region(tp.ncdhw(labels), tp.ncdhw(labels[..., ::-1].copy()), region,
                                mode="softmax"),
               jm.dice_region(labels, labels[..., ::-1], region, mode="softmax"))
    _close(tmet.psnr(tp_, tt), jm.psnr(pred, target))
    assert tmet.REGION_CHANNEL == jm.REGION_CHANNEL


# ------------------------------------------------------------------ modules

def test_discriminator_matches_jax():
    jd = jax_hved.Discriminator(f_maps=8, kernel=3)
    x = np.random.RandomState(5).rand(1, S, S, S, 7).astype(np.float32)
    variables = tp.random_variables(jd, jnp.asarray(x))
    td = Discriminator(f_maps=8, kernel=3)
    td.load_state_dict(params_from_jax(variables["params"]), strict=True)
    want = jax.jit(jd.apply)(tp.to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = td(tp.ncdhw(x))
    assert got.shape == (1, 1, 2, 2, 2)
    _close(tp.ndhwc(got), want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="too small"):
        Discriminator(f_maps=8, kernel=4)(torch.zeros(1, 7, S, S, S))


def test_batchnorm_train_mode_matches_flax():
    """Outputs and running statistics after two train-mode calls (as one G
    step makes), at a spatial size where the unbiased variance would show."""
    rng = np.random.RandomState(6)
    xs = [(2.0 + 3.0 * rng.randn(2, 3, 3, 3, 5)).astype(np.float32) for _ in range(2)]
    bn = fnn.BatchNorm(use_running_average=False)
    variables = tp.random_variables(bn, jnp.asarray(xs[0]))
    tbn = BatchNorm3d(5)
    sd = params_from_jax(variables["params"], variables["batch_stats"])
    tbn.load_state_dict(sd, strict=True)
    tbn.train()
    jv = tp.to_jax(variables)
    for x in xs:
        want, new = bn.apply(jv, jnp.asarray(x), mutable=["batch_stats"])
        jv = {"params": jv["params"], "batch_stats": new["batch_stats"]}
        got = tbn(tp.ncdhw(x))
        _close(tp.ndhwc(got.detach()), want, rtol=1e-5, atol=2e-5)
    _close(tbn.running_mean, jv["batch_stats"]["mean"])
    _close(tbn.running_var, jv["batch_stats"]["var"])
    tbn.eval()  # eval mode: the running statistics
    want = fnn.BatchNorm(use_running_average=True).apply(jv, jnp.asarray(xs[0]))
    _close(tp.ndhwc(tbn(tp.ncdhw(xs[0])).detach()), want, rtol=1e-5, atol=2e-5)


# ------------------------------------------------------------------ the G step

@pytest.fixture(scope="module")
def g_step():
    """The JAX generator objective (the body of make_grad_fn, with its aux)
    and the port's make_grad_fn on the same weights, input, mask and keep."""
    cfg_j, cfg_t = JaxTrainConfig(crop_size=(S,) * 3), TrainConfig(crop_size=(S,) * 3)
    jmodel = jax_hved.HVEDFusionNet(jax_model_cfg())
    jdisc = jax_hved.Discriminator(f_maps=8, kernel=3)
    rng = np.random.RandomState(7)
    x = rng.rand(1, S, S, S, 4).astype(np.float32)
    mask = (rng.rand(1, S, S, S, 3) > 0.7).astype(np.float32)
    gvars = tp.random_variables(jmodel, jnp.asarray(x), seed=8, deterministic=True, recon=True)
    dvars = tp.random_variables(jdisc, jnp.asarray(np.zeros((1, S, S, S, 7), np.float32)), seed=9)
    state = jtrain.TrainState(step=0, params_g=tp.to_jax(gvars["params"]),
                              batch_stats_g=tp.to_jax(gvars["batch_stats"]), opt_state_g=None,
                              params_d=tp.to_jax(dvars["params"]), opt_state_d=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hved, "reparametrize",
                   lambda key, mu, lv, deterministic=False: mu)
        loss_g_fn = jtrain._build_loss_g(jmodel, jdisc, cfg_j)
        fn = jax.jit(lambda s, x, m, k: jax.value_and_grad(loss_g_fn, has_aux=True)(
            s.params_g, s, x, m, k, jax.random.PRNGKey(1), jax.random.PRNGKey(2)))
        (jloss, jaux), jgrads = fn(state, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(KEEP))
    jax_out = dict(loss=float(jloss), losses={k: float(v) for k, v in jaux["losses"].items()},
                   grads=params_from_jax(jax.device_get(jgrads)),
                   new_bs=params_from_jax({}, jax.device_get(jaux["new_bs"])),
                   aux={k: np.asarray(jaux[k]) for k in ("f_seg", "m_seg", "atten_f", "atten_m")})

    model = find_model_using_name("XLSTM_HVED", device="cpu")
    model.load_state_dict(params_from_jax(gvars["params"], gvars["batch_stats"]), strict=True)
    disc = Discriminator(f_maps=8, kernel=3)
    disc.load_state_dict(params_from_jax(dvars["params"]), strict=True)
    xt, mt, keep = tp.ncdhw(x), tp.ncdhw(mask), torch.from_numpy(KEEP)
    loss_g = ttrain._g_objective(model, disc, cfg_t)
    disc.requires_grad_(False)
    tloss, taux = loss_g(xt, mt, keep, deterministic=True)
    disc.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    tgrads = dict(zip(names, torch.autograd.grad(tloss, params, allow_unused=True)))
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(jax=jax_out, port=dict(loss=float(tloss.detach()), aux=taux, grads=tgrads, stats=stats),
                model=model, disc=disc, cfg=cfg_t, dvars=dvars, jdisc=jdisc,
                x=xt, mask=mt, keep=keep)


def jax_model_cfg():
    from xlstm_hved_tpu.config import get_config
    return get_config("XLSTM_HVED", compute_dtype="float32", use_pallas_mlstm=False)


def _assert_grads_close(got, want):
    floor = GRAD_FLOOR * max(float(v.abs().max()) for v in want.values())
    for name, ref in want.items():
        g = got[name]
        assert g is not None and torch.isfinite(g).all(), name
        err = float((g - ref).abs().max())
        assert err <= GRAD_SCALED * float(ref.abs().max()) + floor, (name, err)


def test_g_loss_terms_match_jax(g_step):
    want, got = g_step["jax"]["losses"], g_step["port"]["aux"]["losses"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), want[name], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=name)
    # the forwards' own budget (tests/test_torch_hved.py): seg 1e-3, recon 3.5e-3
    for name, atol in (("f_seg", 1e-3), ("m_seg", 1e-3), ("atten_f", 3.5e-3),
                       ("atten_m", 3.5e-3)):
        _close(tp.ndhwc(g_step["port"]["aux"][name]), g_step["jax"]["aux"][name],
               rtol=0, atol=atol)


def test_g_gradients_match_jax(g_step):
    want, got = g_step["jax"]["grads"], g_step["port"]["grads"]
    assert set(got) == set(want)
    _assert_grads_close(got, want)
    # the gradient reaches the mLSTM gates through the plain scan's autograd
    assert float(got["mvil.vil.layer.mlstm_cell.igate.weight"].abs().max()) > 0


def test_g_step_running_stats_match_jax(g_step):
    """The two train-mode forwards move every running statistic twice, as
    flax's mutable batch_stats do."""
    stats = g_step["port"]["stats"]
    for name, want in g_step["jax"]["new_bs"].items():
        if name.endswith("num_batches_tracked"):
            continue
        _close(stats[name], want, rtol=1e-4, atol=1e-6)


def test_d_loss_and_gradients_match_jax(g_step):
    cfg, jdisc = g_step["cfg"], g_step["jdisc"]
    aux_np = g_step["jax"]["aux"]

    def jax_loss_d(params_d):
        fake = jdisc.apply({"params": params_d},
                           jnp.concatenate([aux_np["m_seg"], aux_np["atten_m"]], axis=-1))
        real = jdisc.apply({"params": params_d},
                           jnp.concatenate([aux_np["f_seg"], aux_np["atten_f"]], axis=-1))
        return cfg.weight_adv * (jl.gan_loss_lsgan(fake, False)
                                 + jl.gan_loss_lsgan(real, True)) * 0.5

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_d))(tp.to_jax(g_step["dvars"])["params"])
    disc = Discriminator(f_maps=8, kernel=3)
    disc.load_state_dict(params_from_jax(g_step["dvars"]["params"]), strict=True)
    aux = {k: tp.ncdhw(v) for k, v in aux_np.items()}
    loss = ttrain.make_loss_d(disc, cfg)(aux)
    names, params = zip(*disc.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jgrads))
    assert set(grads) == set(want)
    _assert_grads_close(grads, want)


def test_train_step_moves_g_d_and_stats(g_step):
    model, disc, cfg = g_step["model"], g_step["disc"], g_step["cfg"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    d_before = {k: v.clone() for k, v in disc.state_dict().items()}
    state = ttrain.create_train_state(model, disc, cfg, 0, g_step["x"])
    model.load_state_dict(before)   # the transplanted weights, not a fresh draw
    disc.load_state_dict(d_before)
    step = ttrain.make_train_step(model, disc, cfg,
                                  freeze_mask={"final_conv.weight": 0.0})
    state, metrics = step(state, g_step["x"], g_step["mask"])
    assert state.step == 1 and 0 <= metrics["subset_idx"] < 14
    for name, value in metrics.items():
        assert np.isfinite(float(value)), name
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert "final_conv.weight" not in moved           # frozen: gradient and update
    assert "init_blocks.weight" in moved and "mvil.vil.layer.mlstm_cell.igate.weight" in moved
    assert "dusfe_0.bn_fuse_ch1.running_mean" in moved
    assert "skr_att_1.res.conv1.BatchNorm_0.running_var" in moved
    assert all(not torch.equal(d_before[k], v) for k, v in disc.state_dict().items())
    x_missing = g_step["x"].clone()
    x_missing[:, 1] = 0.0
    evaluated = ttrain.make_eval_step(model)(g_step["x"], x_missing, g_step["mask"])
    assert set(evaluated) == {"vloss", "dice", "wt_dice", "tc_dice", "ec_dice", "wt_dice_m",
                              "tc_dice_m", "ec_dice_m", "psnr_f", "psnr_m"}
    assert all(torch.isfinite(v) for v in evaluated.values()) and model.training


# ------------------------------------------------------------------ optimizer, samplers, init

def test_adam_l2_poly_matches_optax():
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=1e-2, num_epochs=3)
    jcfg = JaxTrainConfig(learning_rate=1e-2, weight_decay=1e-2, num_epochs=3)
    rng = np.random.RandomState(10)
    w0 = rng.randn(4, 5).astype(np.float32)
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(5)]
    tx = jtrain.make_optimizer(jcfg, steps_per_epoch=2)
    jw, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = ttrain.make_optimizer([p], cfg)
    schedule = ttrain.poly_schedule(cfg.learning_rate, cfg.num_epochs, 2, cfg.poly_power)
    for n, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jw)
        jw = optax.apply_updates(jw, updates)
        ttrain._step(opt, [p], [torch.from_numpy(g)], schedule(n))
        _close(p.detach(), jw, rtol=1e-5, atol=1e-6)
    assert schedule(0) == cfg.learning_rate and schedule(6) == 0.0


def test_subset_sampler_statistics():
    gen = torch.Generator().manual_seed(11)
    draws = np.array([tsub.sample_subset_index(gen) for _ in range(6000)])
    sizes = SUBSET_MASKS[draws].sum(1)
    assert set(np.unique(sizes)) == {1, 2, 3} and 14 not in draws
    for size in (1, 2, 3):   # each size 1/3, each subset uniform within its bucket
        n = np.sum(sizes == size)
        assert abs(n - 2000) < 5 * np.sqrt(6000 * (1 / 3) * (2 / 3))
        lo, hi = tsub.SIZE_BUCKETS[size]
        counts = np.bincount(draws[sizes == size] - lo, minlength=hi - lo)
        expected = n / (hi - lo)
        assert np.all(np.abs(counts - expected) < 5 * np.sqrt(expected))
    again = torch.Generator().manual_seed(11)
    assert [tsub.sample_subset_index(again) for _ in range(20)] == draws[:20].tolist()
    drop = tsub.sample_instance_drop(torch.Generator().manual_seed(12), 4000)
    assert drop.shape == (4000, 4) and not drop.all(dim=1).any()
    assert abs(float(drop.float().mean()) - 0.5 + 0.5 / 16 / 4) < 0.02


def jax_pretrain_cfg():
    from xlstm_hved_tpu.config import get_config
    return get_config("XLSTM_HVED", shared_recon=False, compute_dtype="float32",
                      use_pallas_mlstm=False)


@pytest.fixture(scope="module")
def jax_inits():
    jmodel = jax_hved.HVEDFusionNet(jax_model_cfg())
    jpre = jax_hved.HVEDFusionNet(jax_pretrain_cfg())
    jdisc = jax_hved.Discriminator(f_maps=8, kernel=3)
    x = jnp.zeros((1, S, S, S, 4))
    out = {}
    # the rbg generator: the same distributions, and half the compile time
    # of threefry over two hundred leaves
    with jax.default_prng_impl("rbg"):
        g = jax.jit(lambda k: jmodel.init({"params": k, "latent": k}, x, deterministic=True,
                                          recon=True))(jax.random.PRNGKey(0))["params"]
        pre = jax.jit(lambda k: jpre.init({"params": k, "latent": k}, x, deterministic=True,
                                          recon=True))(jax.random.PRNGKey(3))["params"]
        d = jax.jit(jdisc.init)(jax.random.PRNGKey(1), jnp.zeros((1, S, S, S, 7)))["params"]
        for name, tree in (("g", g), ("pre", pre), ("d", d)):
            ref = jax.jit(jax_reference_init)(tree, jax.random.PRNGKey(2))
            out[name] = (params_from_jax(jax.device_get(tree)),
                         params_from_jax(jax.device_get(ref)))
    return out


def _rms(t, centre=0.0):
    return float(torch.sqrt(((t.double() - centre) ** 2).mean()))


@pytest.mark.parametrize("scheme", ["default", "reference"])
def test_init_schemes_match_jax(jax_inits, scheme):
    """The set of tensors reference_init changes, and every tensor's spread
    under each scheme, against the JAX package (same distributions, other
    draws: the tolerance is six standard errors of an RMS over n values),
    for the flagship, the pretrain net (a recon decoder per modality,
    `shared_recon=False`) and D."""
    for part in ("g", "pre", "d"):
        module = {"g": lambda: find_model_using_name("XLSTM_HVED", device="cpu"),
                  "pre": lambda: find_model_using_name("XLSTM_HVED", device="cpu",
                                                       shared_recon=False),
                  "d": lambda: Discriminator(f_maps=8, kernel=3)}[part]()
        gen = torch.Generator().manual_seed(3)
        default_init(module, gen)
        before = {k: v.clone() for k, v in module.state_dict().items()}
        if scheme == "reference":
            reference_init(module, gen)
        got = module.state_dict()
        jdef, jref = jax_inits[part]
        want = jref if scheme == "reference" else jdef
        if scheme == "reference":
            changed = {k for k in jdef if not torch.equal(jdef[k], jref[k])}
            assert {k for k in jdef if not torch.equal(before[k], got[k])} == changed
        for name, ref in want.items():
            n = ref.numel()
            centre = 1.0 if ("BatchNorm" in name or "bn_fuse" in name) and name.endswith("weight") else 0.0
            r_got, r_want = _rms(got[name], centre), _rms(ref, centre)
            if r_want == 0.0:
                assert r_got == 0.0, name
            elif n >= 16:
                assert abs(r_got - r_want) <= 6.0 / np.sqrt(n) * r_want, (name, r_got, r_want)
