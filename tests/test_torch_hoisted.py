"""PyTorch port: the model's prefix/suffix split and the hoisted 15-subset
sweep against the JAX package, and against the port's own plain sweep.

Overlapping windows as tests/test_engine.py has them: a 24x16x16 volume, a
16^3 patch, two origins along D. Two hoist boundaries: XLSTM_HVED
(skip-return, level 0 hoisted, the stream tensor handed on) and
U_HVEDConvDuSFEmViLNet3D (every level hoisted).

Bounds: the expert stacks as tests/test_torch_hved.py holds them (2e-4),
the hoisted stream tensor as the blocks are held; the sweeps against JAX's
as tests/test_torch_evaluate.py holds the port's plain sweep (seg max 1e-3
/ mean 2e-5, recon 3.5e-3 / 1e-4). Inside the port the hoisted sweep is
bitwise the plain one on the CPU: the kept streams see the same values and
a dropped expert adds an exact 0 to the product of experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import max_abs, model_pair, ncdhw, ndhwc
from xlstm_hved_tpu.engine import evaluate as jeval
from xlstm_hved_tpu.models import find_model_using_name as jax_model
from xlstm_hved_torch.engine import evaluate as teval

PATCH = (16, 16, 16)
PRESETS = ["XLSTM_HVED", "U_HVEDConvDuSFEmViLNet3D"]


@pytest.fixture(scope="module", params=PRESETS)
def pair(request):
    name = request.param
    tm, _, jvars, _ = model_pair(name, shape=(1, *PATCH, 4))
    x = np.random.RandomState(5).rand(1, 24, 16, 16, 4).astype(np.float32)
    jm = jax_model(name, compute_dtype="float32", use_pallas_mlstm=False)
    # the plain sweeps the tests hold the others to, run once per preset:
    # over the two windows, and the first window alone
    plain = {}
    for key, vol in (("volume", x), ("window", x[:, :16])):
        plain[key] = teval.make_subset_sweep(teval.default_apply_fn(tm, recon=True), PATCH,
                                             recon_channels=4)(tm, ncdhw(vol))
    return name, tm, jm, jvars, x, plain


def test_prefix_matches_jax(pair):
    name, tm, jm, jvars, x, _ = pair
    crop = x[:, :16]
    ref = jax.jit(lambda v, c: jm.apply(v, c, mode="prefix", deterministic=True))(
        jvars, jnp.asarray(crop))
    with torch.no_grad():
        got = tm(ncdhw(crop), mode="prefix", deterministic=True)
    levels = 1 if name == "XLSTM_HVED" else 4
    assert len(got.mu) == len(ref.mu) == len(got.logvar) == levels
    for t, j in zip(got.mu + got.logvar, ref.mu + ref.logvar):
        t = np.moveaxis(t.numpy(), 2, -1)  # (B, 5, C, ...) -> (B, 5, ..., C)
        assert t.shape == j.shape and max_abs(t, j) < 2e-4, max_abs(t, j)
    if name == "XLSTM_HVED":  # the folded level-0 streams, m * C + c in both
        assert ndhwc(got.xs).shape == ref.xs.shape
        assert max_abs(ndhwc(got.xs), ref.xs) < 1e-4, max_abs(ndhwc(got.xs), ref.xs)
    else:
        assert got.xs is None and ref.xs is None


def test_hoisted_sweep_matches_plain_and_jax(pair):
    _, tm, jm, jvars, x, plain = pair
    xt = ncdhw(x)
    seg_h, rec_h = teval.make_hoisted_subset_sweep(tm, PATCH, recon_channels=4)(tm, xt)
    seg_p, rec_p = plain["volume"]
    assert seg_h.shape == (15, 1, 3, 24, 16, 16) and rec_h.shape == (15, 1, 4, 24, 16, 16)
    # bit for bit: the hoist changes no value the kept streams see
    assert torch.equal(seg_h, seg_p) and torch.equal(rec_h, rec_p)
    seg_only = teval.make_hoisted_subset_sweep(tm, PATCH)(tm, ncdhw(x[:, :16]))
    assert torch.equal(seg_only, plain["window"][0])

    j_seg, j_rec = jeval.make_hoisted_subset_sweep(jm, PATCH, recon_channels=4)(
        jvars, jnp.asarray(x))
    seg_d = np.abs(np.moveaxis(seg_h.numpy(), 2, -1) - np.asarray(j_seg))
    rec_d = np.abs(np.moveaxis(rec_h.numpy(), 2, -1) - np.asarray(j_rec))
    assert seg_d.max() < 1e-3 and seg_d.mean() < 2e-5, (seg_d.max(), seg_d.mean())
    assert rec_d.max() < 3.5e-3 and rec_d.mean() < 1e-4, (rec_d.max(), rec_d.mean())


def test_mode_errors(pair):
    _, tm, _, _, x, _ = pair
    xt = ncdhw(x[:, :16])
    with torch.no_grad():
        with pytest.raises(ValueError, match="unknown mode"):
            tm(xt, mode="middle", deterministic=True)
        with pytest.raises(ValueError, match="needs the HoistedPrefix"):
            tm(xt, mode="suffix", deterministic=True)
        cfg = tm.cfg
        try:
            tm.cfg = dataclasses.replace(cfg, fusion=True)
            with pytest.raises(ValueError, match="require an MVAE model"):
                tm(xt, mode="prefix", deterministic=True)
        finally:
            tm.cfg = cfg


@pytest.mark.parametrize("chunk", [4, 6])
def test_subset_chunk_matches_chunk_1(pair, chunk):
    """A chunk runs as one batch of per-instance keep-masks (one window); a
    batch sums its convs in another order than a batch of 1
    (tests/test_torch_hved.py bounds that at 1e-4 on seg). The recon head
    has no norm after its last convs, so it keeps that rounding at the
    scale of the amplified features: measured up to 1.6e-4, bounded at 1e-3
    (its bound against JAX is 3.5e-3)."""
    _, tm, _, _, x, plain = pair
    seg_1, rec_1 = plain["window"]
    seg_c, rec_c = teval.make_subset_sweep(teval.default_apply_fn(tm, recon=True), PATCH,
                                           recon_channels=4, subset_chunk=chunk)(
        tm, ncdhw(x[:, :16]))
    assert seg_c.shape == seg_1.shape and rec_c.shape == rec_1.shape
    torch.testing.assert_close(seg_c, seg_1, rtol=0, atol=1e-4)
    torch.testing.assert_close(rec_c, rec_1, rtol=0, atol=1e-3)


@pytest.mark.parametrize("chunk", [0, 16])
def test_subset_chunk_out_of_range_raises(chunk):
    with pytest.raises(ValueError, match="subset_chunk"):
        teval.make_subset_sweep(lambda *a: None, PATCH, subset_chunk=chunk)


def test_subset_chunk_with_a_batch_of_two(pair):
    """Rows of a chunk are (subset, batch item) pairs: with B = 2 each item's
    sweep is its own sweep at B = 1."""
    _, tm, _, _, x, plain = pair
    apply_fn = teval.default_apply_fn(tm)
    win = x[:, :16]
    xb = ncdhw(np.concatenate([win, win[:, ::-1]], axis=0))
    both = teval.make_subset_sweep(apply_fn, PATCH, subset_chunk=4)(tm, xb)
    assert both.shape == (15, 2, 3, 16, 16, 16)
    torch.testing.assert_close(both[:, :1], plain["window"][0], rtol=0, atol=1e-4)
    flipped = teval.make_subset_sweep(apply_fn, PATCH)(tm, xb[1:])
    torch.testing.assert_close(both[:, 1:], flipped, rtol=0, atol=1e-4)
