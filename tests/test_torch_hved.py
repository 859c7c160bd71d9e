"""PyTorch port: the whole XLSTM_HVED seg+recon forward against the JAX model
at (1, 4, 32, 32, 32), fp32, deterministic latents, every keep-mask.

Bounds start from tests/test_torch_parity.py (the JAX model against the
upstream PyTorch model: seg max 1.5e-3 / mean 2e-5, recon max 5e-3 / mean
1e-4, mu/logvar 5e-4); the max bounds are tightened to about twice the
largest error over the 15 masks that tests/torch_parity_report.py prints
(seg 3.7e-4, recon 1.7e-3, mu/logvar 9.1e-5; means 1.5e-5 and 8.8e-5).
Stacked InstanceNorms condition this graph at about 1e3, so the mean error
is the tight signal. Against an fp64 run of the port (same report), the
port's fp32 forward is about ten times closer than the JAX CPU forward, so
these errors are mostly the JAX side's rounding."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import max_abs, model_pair, ncdhw, ndhwc
from xlstm_hved_tpu.utils.subsets import SUBSET_MASKS

@pytest.fixture(scope="module")
def flagship():
    return model_pair("XLSTM_HVED")


def _run_port(tm, x, keep, **kw):
    with torch.no_grad():
        return tm(ncdhw(x), keep=torch.tensor(keep), recon=True, deterministic=True, **kw)


def _assert_close(out, ref, seg_max=1e-3, seg_mean=2e-5):
    seg_d = np.abs(ndhwc(out.seg) - np.asarray(ref.seg))
    rec_d = np.abs(ndhwc(out.recon) - np.asarray(ref.recon))
    assert seg_d.max() < seg_max, seg_d.max()
    assert seg_d.mean() < seg_mean, seg_d.mean()
    assert rec_d.max() < 3.5e-3, rec_d.max()
    assert rec_d.mean() < 1e-4, rec_d.mean()
    assert len(out.mu) == len(ref.mu) == 4
    for lvl in range(4):
        # expert stacks: (B, 5, C, D, H, W) in the port, (B, 5, D, H, W, C) in JAX
        for t, j in ((out.mu[lvl], ref.mu[lvl]), (out.logvar[lvl], ref.logvar[lvl])):
            t = np.moveaxis(t.numpy(), 2, -1)
            assert t.shape == j.shape
            assert max_abs(t, j) < 2e-4, (lvl, max_abs(t, j))


@pytest.mark.parametrize("subset", range(15))
def test_flagship_forward_matches_jax(flagship, subset):
    tm, fwd, jvars, x = flagship
    keep = SUBSET_MASKS[subset]
    out = _run_port(tm, x, keep)
    assert out.seg.shape == (1, 3, 32, 32, 32) and out.recon.shape == (1, 4, 32, 32, 32)
    _assert_close(out, fwd(jvars, jnp.asarray(x), jnp.asarray(keep)))


@pytest.mark.parametrize("name", ["XLSTM_HVED_woSMVAE", "XLSTM_HVED_woDuSFE",
                                  "U_HVEDConvNet3D"])
def test_mvae_siblings_match_jax(name):
    tm, fwd, jvars, x = model_pair(name, seed=1)
    keep = SUBSET_MASKS[11]
    _assert_close(_run_port(tm, x, keep), fwd(jvars, jnp.asarray(x), jnp.asarray(keep)))


def test_per_instance_keep_and_instance_missing(flagship):
    tm, _, _, x = flagship
    xb = np.concatenate([x, x[:, ::-1]], axis=0)
    keep = SUBSET_MASKS[[2, 12]]
    both = _run_port(tm, xb, keep)
    # a batch of 2 sums its convs in another order than a batch of 1; the
    # graph's ~1e3 conditioning turns that into ~1e-5
    for b in range(2):
        one = _run_port(tm, xb[b:b + 1], keep[b])
        torch.testing.assert_close(both.seg[b:b + 1], one.seg, rtol=0, atol=1e-4)
        torch.testing.assert_close(both.recon[b:b + 1], one.recon, rtol=0, atol=1e-4)
    # instance_missing infers the keep-mask from all-zero modality channels
    xz = xb * keep[:, None, None, None, :]
    with torch.no_grad():
        inferred = tm(ncdhw(xz), instance_missing=True, recon=True, deterministic=True)
    explicit = _run_port(tm, xz, keep)
    torch.testing.assert_close(inferred.seg, explicit.seg, rtol=0, atol=0)


def test_sampling_uses_the_generator(flagship):
    tm, _, _, x = flagship
    keep = torch.tensor(SUBSET_MASKS[14])

    def sample(seed):
        with torch.no_grad():
            return tm(ncdhw(x), keep=keep, recon=True,
                      generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(3), sample(3), sample(4)
    torch.testing.assert_close(a.seg, b.seg, rtol=0, atol=0)
    assert torch.isfinite(a.seg).all() and torch.isfinite(a.recon).all()
    assert not torch.equal(a.seg, c.seg)
    with torch.no_grad(), pytest.raises(ValueError, match="Generator"):
        tm(ncdhw(x), keep=keep)


def test_seg_and_recon_flags(flagship):
    tm, _, _, x = flagship
    with torch.no_grad():
        out = tm(ncdhw(x), deterministic=True)
        no_seg = tm(ncdhw(x), seg=False, recon=True, deterministic=True)
    assert out.recon is None and out.seg.shape == (1, 3, 32, 32, 32)
    assert no_seg.seg is None and no_seg.recon.shape == (1, 4, 32, 32, 32)
    assert float(out.seg.min()) >= 0.0 and float(out.seg.max()) <= 1.0


@pytest.fixture(scope="module")
def vil_decoder():
    return model_pair("U_HVEDConvXLSTMNet3D", seed=2)


@pytest.mark.parametrize("subset", [0, 5, 11, 14])
def test_vil_decoder_preset_matches_jax(vil_decoder, subset):
    """U_HVEDConvXLSTMNet3D: seg decoder stage 0 is DoubleConvViL (a ViL over
    the 8^3 stage-0 tokens at 32^3, dim 16, 4 heads of width 8); the JAX
    tree loaded strictly through params_from_jax (model_pair).

    The per-head out-norm over 8 values amplifies fp32 rounding in the seg
    head: against an fp64 run of the port, the JAX CPU forward's seg is off
    by up to 2.0e-3 max / 3.6e-5 mean (subset 11), the port's fp32 by at most
    2.0e-4 / 4.6e-6. So seg is held to JAX at twice JAX's own error (4e-3 /
    8e-5) and to the fp64 port at the flagship's bounds (1e-3 / 2e-5); recon
    and the experts at the flagship's bounds."""
    tm, fwd, jvars, x = vil_decoder
    assert "sdecoder_0.basic.vil.vil.layer.mlstm_cell.igate.weight" in tm.state_dict()
    keep = SUBSET_MASKS[subset]
    out = _run_port(tm, x, keep)
    _assert_close(out, fwd(jvars, jnp.asarray(x), jnp.asarray(keep)), seg_max=4e-3,
                  seg_mean=8e-5)
    with torch.no_grad():
        ref64 = copy.deepcopy(tm).double()(ncdhw(x).double(), keep=torch.tensor(keep),
                                           deterministic=True)
    seg_d = (out.seg.double() - ref64.seg).abs()
    assert seg_d.max() < 1e-3 and seg_d.mean() < 2e-5, (seg_d.max(), seg_d.mean())
