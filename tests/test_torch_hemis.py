"""PyTorch port: the U-HeMIS baseline (`xlstm_hved_torch/models/hemis.py`) against
the JAX package's `models/hemis.py`, and its place in the registry.

- UHeMIS at 16^3 (n_base 4 and 8), softmax and sigmoid heads, on the same
  numpy-drawn weights (tests/_torch_port.py), fp32: with `keep` given for
  all modalities and for subsets, and with `keep` inferred from a zeroed
  modality. Bound: max|d| <= 1e-4 * max(1, max|ref|) on seg and recon; the
  largest seen is 4.1e-5 (recon of 3.5).
- `hemis_abstraction`: the mean and the unbiased variance over the streams.
- The converter reads the four `nn.vmap`ped encoders' leaves (a leading axis
  of 4) as the grouped convs of the folded layout: the model loads
  strictly, and stream m's kernel lands in output channels [m C, (m+1) C).
- The registry builds UHeMIS for "U_HeMIS" (`compute_dtype` becomes its
  `dtype`, `remat` is dropped), and `available_models()` lists what JAX's
  does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from xlstm_hved_tpu.models import available_models as jax_available_models
from xlstm_hved_tpu.models import hemis as jh
from xlstm_hved_tpu.utils.subsets import SUBSET_MASKS
from xlstm_hved_torch.models import available_models, find_model_using_name
from xlstm_hved_torch.models import hemis as th
from xlstm_hved_torch.utils.convert import params_from_jax

FWD_SCALED = 1e-4
S = 16


def _pair(seed=0, n_base=4, final_sigmoid=False, zero=None):
    x = np.random.RandomState(seed).rand(1, S, S, S, 4).astype(np.float32)
    if zero is not None:
        x[..., zero] = 0.0
    jm = jh.UHeMIS(num_cls=3, n_base=n_base, final_sigmoid=final_sigmoid)
    tm = th.UHeMIS(num_cls=3, n_base=n_base, final_sigmoid=final_sigmoid)
    variables = tp.random_variables(jm, jnp.asarray(x), seed=seed + 7)
    tp.load_port(tm, variables)
    return jm, tm, tp.to_jax(variables), x


def _assert_close(got, want):
    for g, w in zip(got, want):
        g = tp.ndhwc(g)
        assert g.shape == w.shape and np.all(np.isfinite(g))
        assert tp.max_abs(g, w) <= FWD_SCALED * max(1.0, float(np.abs(np.asarray(w)).max()))


@pytest.fixture(scope="module", params=[False, True], ids=["softmax", "sigmoid"])
def head(request):
    """One pair per head, and one JAX compile: `keep` is a traced argument."""
    jm, tm, jvars, x = _pair(seed=int(request.param), final_sigmoid=request.param)
    return tm, jax.jit(lambda v, x, k: jm.apply(v, x, keep=k)), jvars, x


@pytest.mark.parametrize("subset", [14, 0, 5, 10])
def test_uhemis_matches_jax_with_keep_given(head, subset):
    tm, fwd, jvars, x = head
    keep = SUBSET_MASKS[subset]
    want = fwd(jvars, jnp.asarray(x), jnp.asarray(keep))
    with torch.no_grad():
        got = tm(tp.ncdhw(x), keep=torch.tensor(keep))
    assert got[0].shape == (1, 3, S, S, S) and got[1].shape == (1, 4, S, S, S)
    _assert_close(got, want)


@pytest.mark.parametrize("zero", [None, 2])
def test_uhemis_matches_jax_with_keep_inferred(zero):
    jm, tm, jvars, x = _pair(seed=3, n_base=8, zero=zero)
    want = jax.jit(jm.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = tm(tp.ncdhw(x))
        if zero is not None:   # the zeroed modality is inferred as dropped
            keep = torch.tensor([m != zero for m in range(4)])
            explicit = tm(tp.ncdhw(x), keep=keep)
            assert all(torch.equal(a, b) for a, b in zip(got, explicit))
    _assert_close(got, want)
    assert float((got[0].sum(1) - 1.0).abs().max()) < 1e-5   # a softmax over classes


def test_hemis_abstraction_matches_jax():
    stack = np.random.RandomState(4).randn(4, 2, 3, 3, 3, 5).astype(np.float32)
    want = np.asarray(jh.hemis_abstraction(jnp.asarray(stack)))         # (B, ..., 2C)
    got = th.hemis_abstraction(torch.from_numpy(np.moveaxis(stack, -1, 2)).transpose(0, 1))
    np.testing.assert_allclose(tp.ndhwc(got), want, rtol=1e-5, atol=1e-6)


def test_params_from_jax_reads_the_vmapped_encoders_as_grouped_convs():
    jm, tm, jvars, x = _pair(seed=1)
    variables = tp.random_variables(jm, jnp.asarray(x), seed=2)
    state = params_from_jax(variables["params"])
    tm.load_state_dict(state, strict=True)
    leaf = np.asarray(variables["params"]["encoders"]["block1"]["conv1"]["Conv3DFast_0"]["kernel"])
    assert leaf.shape == (4, 3, 3, 3, 2, 8)           # (M, k, k, k, cin, cout) per stream
    weight = tm.encoders.block1.conv1.Conv3DFast_0.weight.detach().numpy()
    assert weight.shape == (32, 2, 3, 3, 3)           # groups = 4
    for m in range(4):
        np.testing.assert_array_equal(weight[8 * m:8 * (m + 1)],
                                      leaf[m].transpose(4, 3, 0, 1, 2))
    bias = np.asarray(variables["params"]["encoders"]["block1"]["conv1"]["Conv3DFast_0"]["bias"])
    np.testing.assert_array_equal(
        tm.encoders.block1.conv1.Conv3DFast_0.bias.detach().numpy(), bias.reshape(-1))


def test_registry_builds_uhemis():
    model = find_model_using_name("U_HeMIS", device="cpu", seed=1)
    assert isinstance(model, th.UHeMIS) and not model.training
    bf16 = find_model_using_name("U_HeMIS", device="cpu", compute_dtype="bfloat16",
                                 remat=True, n_base=4)
    assert bf16.encoders.init.conv.compute_dtype == torch.bfloat16
    x = torch.rand(1, 4, S, S, S)
    with torch.no_grad():
        seg, recon = bf16(x)
    assert seg.dtype == torch.bfloat16 and recon.shape == (1, 4, S, S, S)
    with pytest.raises(TypeError):   # HVED config fields are not UHeMIS's
        find_model_using_name("U_HeMIS", device="cpu", num_levels=3)


def test_available_models_match_jax():
    assert available_models() == jax_available_models()
    for name in available_models():
        find_model_using_name(name, device="cpu")
