"""PyTorch port: the UxLSTM nnU-Net family (`xlstm_hved_torch/models/uxlstm.py`)
against the JAX package's `models/uxlstm.py`.

- The schedules (`mixer_schedule`, `channel_token_schedule`, the nnU-Net
  block caps) equal JAX's.
- UXlstmEnc and UXlstmBot, 3-D and 2-D, with and without deep supervision,
  and `build_uxlstm_from_plans` on plans dicts of both ranks: forwards on
  the same numpy-drawn weights (tests/_torch_port.py), carried across by
  `params_from_jax` (4-D and 5-D conv kernels), on JAX's CPU path (the
  chunkwise mLSTM scan), fp32. Bound: max|d| <= 1e-4 * max(1, max|ref|) per
  output; the largest seen is 1.1e-5 of that scale (7.5e-5 on logits of 7).
- One UXlstmEnc 3-D gradient (a seeded weighted sum of its deep-supervision
  outputs) against `jax.grad` in fp32, per tensor max|d| <= 2e-3 * max|ref|
  + 2e-5 * (the largest gradient), tests/test_torch_train.py's rule; the
  worst tensor sits at 0.30 of it. JAX's fp32 gradient is not the noisier
  side here: against an fp64 run of the port both lie near (relative L2 over
  all tensors 1.1e-4 for JAX, 4.3e-5 for the port), so the two are held to
  each other directly, and over all tensors within 1e-3.
- The converter's 4-D rule: a 2-D UXlstmBot loads a JAX tree strictly, and
  each (kh, kw, Cin, Cout) kernel lands as (Cout, Cin, kh, kw).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from xlstm_hved_tpu.models import uxlstm as ju
from xlstm_hved_torch.models import UXlstmBot, UXlstmEnc, build_uxlstm_from_plans
from xlstm_hved_torch.models import uxlstm as tu
from xlstm_hved_torch.utils.convert import params_from_jax

FWD_SCALED = 1e-4
GRAD_SCALED, GRAD_FLOOR, GRAD_GLOBAL = 2e-3, 2e-5, 1e-3

STRIDES_3D = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))
# name -> (class name, input size, input channels, features, strides, deep supervision)
CONFIGS = {
    # maps 16^3 .. 2^3: the last stage tokenises over channels (8 voxels <= 32)
    "enc_3d": ("UXlstmEnc", (16, 16, 16), 2, (4, 8, 16, 32), STRIDES_3D, False),
    "enc_3d_ds": ("UXlstmEnc", (16, 16, 16), 2, (4, 8, 16, 32), STRIDES_3D, True),
    "bot_3d_ds": ("UXlstmBot", (16, 16, 16), 2, (4, 8, 16, 32), STRIDES_3D, True),
    # 2-D: a conv mixer on stage 1, ViL on stage 3 (channel tokens, 4 voxels)
    "enc_2d_ds": ("UXlstmEnc", (16, 16), 1, (4, 8, 16, 32), (1, 2, 2, 2), True),
    "bot_2d_ds": ("UXlstmBot", (16, 16), 1, (4, 8, 16), (1, 2, 2), True),
    "enc_2d": ("UXlstmEnc", (16, 16), 1, (4, 8, 16), (1, 2, 2), False),
}
PLANS = {
    "3d": {"patch_size": [16, 16, 16], "conv_kernel_sizes": [[3, 3, 3]] * 3,
           "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
           "n_conv_per_stage_encoder": [1, 1, 1], "n_conv_per_stage_decoder": [1, 1],
           "UNet_base_num_features": 4, "unet_max_num_features": 8},
    # anisotropic: the last pool halves only the first axis, as nnU-Net plans
    # do for an axis that cannot be halved again
    "2d": {"patch_size": [24, 20], "conv_kernel_sizes": [[3, 3]] * 4,
           "pool_op_kernel_sizes": [[1, 1], [2, 2], [2, 2], [2, 1]],
           "n_conv_per_stage_encoder": [2, 2, 2, 2], "n_conv_per_stage_decoder": [2, 2, 2],
           "UNet_base_num_features": 4, "unet_max_num_features": 16},
}


def _pair(name):
    cls, size, cin, feats, strides, ds = CONFIGS[name]
    kw = dict(strides=strides, n_conv_per_stage=1, n_conv_per_stage_decoder=1,
              deep_supervision=ds)
    return (getattr(ju, cls)(size, cin, feats, 3, **kw),
            getattr(tu, cls)(size, cin, feats, 3, **kw), (2, *size, cin))


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _assert_forward_close(jm, tm, shape, seed=0):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    variables = tp.random_variables(jm, jnp.asarray(x), seed=seed + 3)
    tp.load_port(tm, variables)
    want = _outputs(jax.jit(jm.apply)(tp.to_jax(variables), jnp.asarray(x)))
    with torch.no_grad():
        got = _outputs(tm(tp.ncdhw(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = tp.ndhwc(g)
        assert g.shape == w.shape and np.all(np.isfinite(g))
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert tp.max_abs(g, w) <= FWD_SCALED * scale, (tp.max_abs(g, w), scale)
    return got


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("n_stages", [3, 4, 5, 6, 7, 8])
def test_mixer_schedule_matches_jax(n_stages, ndim):
    assert tu.mixer_schedule(n_stages, ndim) == ju.mixer_schedule(n_stages, ndim)


@pytest.mark.parametrize("size,feats,strides", [
    ((16, 16, 16), (4, 8, 16, 32), STRIDES_3D),
    ((128, 128, 128), (32, 64, 128, 256, 320, 320), [(1, 1, 1)] + [(2, 2, 2)] * 5),
    ((192, 160), (32, 64, 128, 256, 512, 512, 512), [(1, 1)] + [(2, 2)] * 5 + [(2, 1)]),
    ((20, 12), (4, 8, 16), [(1, 1), (2, 2), (2, 1)]),
])
def test_channel_token_schedule_matches_jax(size, feats, strides):
    got = tu.channel_token_schedule(size, feats, strides)
    assert got == ju.channel_token_schedule(size, feats, strides)


@pytest.mark.parametrize("n_stages,n_blocks,n_dec", [(4, 2, 2), (6, [2] * 6, [2] * 5),
                                                      (7, [3] * 7, [2] * 6), (5, 1, 1)])
def test_nnunet_block_caps_match_jax(n_stages, n_blocks, n_dec):
    assert tu._nnunet_block_caps(n_stages, n_blocks, n_dec) == ju._nnunet_block_caps(
        n_stages, n_blocks, n_dec)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jm, tm, shape = _pair(name)
    got = _assert_forward_close(jm, tm, shape)
    ds = CONFIGS[name][-1]
    assert len(got) == (len(CONFIGS[name][3]) - 1 if ds else 1)
    assert tuple(got[0].shape[2:]) == CONFIGS[name][1]   # highest resolution first


@pytest.mark.parametrize("rank", sorted(PLANS))
@pytest.mark.parametrize("variant", ["enc", "bot"])
def test_build_from_plans_matches_jax(rank, variant):
    plans = PLANS[rank]
    jm = ju.build_uxlstm_from_plans(plans, 2, 3, deep_supervision=True, variant=variant)
    tm = build_uxlstm_from_plans(plans, 2, 3, deep_supervision=True, variant=variant)
    assert isinstance(tm, UXlstmEnc if variant == "enc" else UXlstmBot)
    assert isinstance(tm.decoder.seg1, torch.nn.Conv3d if rank == "3d" else torch.nn.Conv2d)
    _assert_forward_close(jm, tm, (1, *plans["patch_size"], 2), seed=1)


def test_params_from_jax_takes_4d_kernels_on_a_2d_bot():
    jm, tm, shape = _pair("bot_2d_ds")
    variables = tp.random_variables(jm, jnp.zeros(shape), seed=5)
    state = params_from_jax(variables["params"])
    tm.load_state_dict(state, strict=True)
    kernel = np.asarray(variables["params"]["decoder"]["dec1_res"]["conv1"]["kernel"])
    assert kernel.ndim == 4   # (kh, kw, Cin, Cout)
    weight = tm.decoder.dec1_res.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(weight, kernel.transpose(3, 2, 0, 1))
    assert weight.shape == (8, 16, 3, 3)


def test_gradient_matches_jax_grad():
    jm, tm, shape = _pair("enc_3d_ds")
    rs = np.random.RandomState(0)
    x = rs.rand(1, *shape[1:]).astype(np.float32)
    variables = tp.random_variables(jm, jnp.asarray(x), seed=3)
    tp.load_port(tm, variables)
    outs = jm.apply(tp.to_jax(variables), jnp.asarray(x))
    weights = [rs.randn(*o.shape).astype(np.float32) for o in outs]

    def jax_loss(params, x):
        return sum(jnp.sum(o * w) for o, w in zip(jm.apply({"params": params}, x), weights))

    want = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(jax_loss))(
        tp.to_jax(variables)["params"], jnp.asarray(x))))
    loss = sum((o * tp.ncdhw(w)).sum() for o, w in zip(tm(tp.ncdhw(x)), weights))
    names, params = zip(*tm.named_parameters())
    got = torch.autograd.grad(loss, params)
    assert set(names) == set(want)
    top = max(float(t.abs().max()) for t in want.values())
    for name, g in zip(names, got):
        ref = want[name]
        bound = GRAD_SCALED * float(ref.abs().max()) + GRAD_FLOOR * top
        assert float((g - ref).abs().max()) <= bound, name
    flat = lambda ts: torch.cat([t.flatten() for t in ts])
    ref = flat([want[n] for n in names])
    assert float((flat(got) - ref).norm() / ref.norm()) <= GRAD_GLOBAL
