"""PyTorch port: sliding-window inference and the 15-subset sweep against the
JAX engine, and the sweep against its own per-subset windows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import model_pair, ncdhw, ndhwc
from xlstm_hved_tpu.engine import evaluate as jeval
from xlstm_hved_torch.engine import evaluate as teval
from xlstm_hved_torch.utils.subsets import SUBSET_MASKS

VOLUME = (1, 32, 48, 32, 4)  # NDHWC


@pytest.mark.parametrize("shape,patch,stride", [
    ((32, 48, 32), (32, 32, 32), (32, 32, 32)),
    ((128, 192, 128), (128, 128, 128), (128, 128, 128)),
    ((240, 240, 155), (128, 128, 128), (64, 64, 64)),
    ((100, 64, 70), (64, 64, 64), (48, 32, 16)),
])
def test_origin_grid_matches_jax(shape, patch, stride):
    np.testing.assert_array_equal(teval.origin_grid(shape, patch, stride),
                                  jeval.origin_grid(shape, patch, stride))
    for d, p, s in zip(shape, patch, stride):
        assert teval.window_origins(d, p, s) == jeval.window_origins(d, p, s)


@pytest.fixture(scope="module")
def volume_pair():
    tm, _, jvars, _ = model_pair("XLSTM_HVED")
    x = np.random.RandomState(7).rand(*VOLUME).astype(np.float32)
    return tm, jvars, x


def test_sliding_window_matches_jax(volume_pair):
    from xlstm_hved_tpu.models import find_model_using_name as jax_model

    tm, jvars, x = volume_pair
    keep = SUBSET_MASKS[12]
    jm = jax_model("XLSTM_HVED", compute_dtype="float32", use_pallas_mlstm=False)
    j_pred = jeval.make_sliding_window(jeval.default_apply_fn(jm, recon=True),
                                       (32, 32, 32), recon_channels=4)
    j_seg, j_rec = j_pred(jvars, jnp.asarray(x), jnp.asarray(keep))
    t_pred = teval.make_sliding_window(teval.default_apply_fn(tm, recon=True),
                                       (32, 32, 32), recon_channels=4)
    t_seg, t_rec = t_pred(tm, ncdhw(x), torch.tensor(keep))
    assert t_seg.shape == (1, 3, 32, 48, 32) and t_rec.shape == (1, 4, 32, 48, 32)
    seg_d = np.abs(ndhwc(t_seg) - np.asarray(j_seg))
    rec_d = np.abs(ndhwc(t_rec) - np.asarray(j_rec))
    assert seg_d.max() < 1e-3 and seg_d.mean() < 2e-5, (seg_d.max(), seg_d.mean())
    assert rec_d.max() < 3.5e-3 and rec_d.mean() < 1e-4, (rec_d.max(), rec_d.mean())


def test_subset_sweep_equals_per_subset_windows(volume_pair):
    tm, _, x = volume_pair
    apply_fn = teval.default_apply_fn(tm, recon=True)
    stride = (32, 16, 32)  # two overlapping windows along H
    sweep = teval.make_subset_sweep(apply_fn, (32, 32, 32), stride, recon_channels=4)
    predict = teval.make_sliding_window(apply_fn, (32, 32, 32), stride, recon_channels=4)
    xt = ncdhw(x)
    segs, recs = sweep(tm, xt)
    assert segs.shape == (15, 1, 3, 32, 48, 32) and recs.shape == (15, 1, 4, 32, 48, 32)
    for s, keep in enumerate(SUBSET_MASKS):
        seg, rec = predict(tm, xt, torch.tensor(keep))
        torch.testing.assert_close(segs[s], seg, rtol=0, atol=0)
        torch.testing.assert_close(recs[s], rec, rtol=0, atol=0)
    seg_only = teval.make_subset_sweep(apply_fn, (32, 32, 32), stride)(tm, xt)
    torch.testing.assert_close(seg_only, segs, rtol=0, atol=0)


def test_label_volume_matches_jax():
    seg = np.random.RandomState(3).rand(2, 3, 6, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(teval.label_volume_from_probs(seg),
                                  jeval.label_volume_from_probs(ndhwc(seg)))
