"""PyTorch port: the HVED config arms that no preset sets, each against the
JAX model on the same numpy-drawn weights (tests/_torch_port.py), fp32,
deterministic latents, one drawn subset (t1c, t2f, t2w kept):

- `fusion_level=3`: a single-stream deep level, an EncoderStage on the
  level above's decoder feature, as the JAX model implements it (not the
  upstream forward, which cannot run this arm); on the flagship, so the
  skip-return chain and the mid-ViL run through it too;
- `mvae_reduction=False`: the encoder's streams are the experts, no DRB and
  no VU block; the decoder widths follow the config (halved for
  ext-resnet, U_HVEDNet3D; the double-conv case, with DuSE and skip-return,
  is in tests/test_torch_zoo.py, to keep each file under a minute);
- `recon_skip=False`: the recon ladder upsamples x2 with no skip (at 32^3:
  at 16^3 the deepest latent is one voxel, the VU block's InstanceNorm
  zeroes it, and a recon ladder with no skip then normalises constant
  fields, so fp32 rounding decides its output: both fp32 runs lie 4-7 from
  an fp64 run of the port whose output is below 0.4);
- `recon_decoder=False`: no recon ladder, recon None;
- `final_sigmoid=False`: a softmax over the three channels;
- `fusion=False` on the non-MVAE config: the plain multi-stream concat of
  the keep-masked streams.

Bounds as tests/test_torch_hved.py holds the flagship (seg max 1e-3 / mean
2e-5, recon max 3.5e-3 / mean 1e-4, the experts 2e-4); the largest errors
seen are 4.4e-5 (seg) and 1.3e-3 (recon, recon_skip=False at 32^3, where an
fp64 run of the port lies 1.1e-4 from the port's and 1.3e-3 from JAX's).
A fusion_level=3 model without skip-return hoists its three multi-stream
levels and its hoisted sweep is the plain one bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from test_torch_zoo import assert_forward_close
from xlstm_hved_tpu.utils.subsets import SUBSET_MASKS
from xlstm_hved_torch.engine import evaluate as teval
from xlstm_hved_torch.models import find_model_using_name

KEEP = SUBSET_MASKS[11]
ARMS = [
    ("XLSTM_HVED", dict(fusion_level=3), 16),
    ("U_HVEDNet3D", dict(mvae_reduction=False), 16),
    ("U_HVEDNet3D", dict(recon_skip=False), 32),
    ("U_HVEDConvNet3D", dict(recon_decoder=False), 16),
    ("U_HVEDConvNet3D", dict(final_sigmoid=False), 16),
    ("FusionUNet3D", dict(fusion=False), 16),
]


@pytest.mark.parametrize("name,overrides,size", ARMS,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in o.items())}"
                              for n, o, _ in ARMS])
def test_config_arm_matches_jax(name, overrides, size):
    tm, fwd, jvars, x = tp.model_pair(name, seed=1, shape=(1, size, size, size, 4),
                                      **overrides)
    with torch.no_grad():
        out = tm(tp.ncdhw(x), keep=torch.tensor(KEEP), recon=True, deterministic=True)
    want = fwd(jvars, jnp.asarray(x), jnp.asarray(KEEP))
    levels = {"fusion_level": 3, "fusion": 0}.get(next(iter(overrides)), 4)
    if overrides.get("recon_decoder") is False:
        assert out.recon is None and want.recon is None
        seg_d = np.abs(tp.ndhwc(out.seg) - np.asarray(want.seg))
        assert seg_d.max() < 1e-3 and seg_d.mean() < 2e-5, (seg_d.max(), seg_d.mean())
        assert not any(k.startswith(("rdecoder", "rfinal")) for k in tm.state_dict())
        return
    assert_forward_close(out, want, levels)
    if overrides.get("final_sigmoid") is False:
        torch.testing.assert_close(out.seg.sum(dim=1), torch.ones_like(out.seg[:, 0]))


def test_single_stream_deep_level_hoists_the_multi_stream_levels():
    tm = find_model_using_name("U_HVEDConvNet3D", device="cpu", seed=4, fusion_level=3)
    x = torch.rand(1, 4, 24, 16, 16, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        pref = tm(x[:, :, :16], mode="prefix", deterministic=True)
    assert len(pref.mu) == 3 and pref.xs is None
    patch = (16, 16, 16)
    plain = teval.make_subset_sweep(teval.default_apply_fn(tm, recon=True), patch,
                                    recon_channels=4)(tm, x)
    hoisted = teval.make_hoisted_subset_sweep(tm, patch, recon_channels=4)(tm, x)
    assert torch.equal(hoisted[0], plain[0]) and torch.equal(hoisted[1], plain[1])


def test_the_fusion_arm_refuses_single_stream_levels():
    """The JAX fusion model with fusion_level < num_levels indexes past its
    seg skips; the port refuses the config when it is built."""
    with pytest.raises(ValueError, match="fusion_level"):
        find_model_using_name("FusionUNet3D", device="cpu", fusion_level=3)
