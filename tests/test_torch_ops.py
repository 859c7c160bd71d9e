"""PyTorch port: subset table and product-of-experts against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (TF32 off)
from xlstm_hved_tpu.ops import poe as jpoe
from xlstm_hved_tpu.utils import subsets as jsubsets
from xlstm_hved_torch.ops import poe
from xlstm_hved_torch.utils import subsets


def test_subset_table_matches_jax():
    np.testing.assert_array_equal(subsets.SUBSET_MASKS, jsubsets.SUBSET_MASKS)
    assert subsets.SUBSETS_MODALITIES == jsubsets.SUBSETS_MODALITIES
    assert subsets.SUBSET_MASKS.shape == (15, 4)
    for s in range(15):
        np.testing.assert_array_equal(subsets.subset_mask(s).numpy(),
                                      np.asarray(jsubsets.subset_mask(s)))
        np.testing.assert_array_equal(subsets.drop_mask(s).numpy(),
                                      np.asarray(jsubsets.drop_mask(s)))


def _experts(seed, B=2, C=3, sp=(4, 5, 6)):
    rng = np.random.RandomState(seed)
    mu = rng.randn(B, 4, C, *sp).astype(np.float32)
    logvar = (2.0 * rng.randn(B, 4, C, *sp)).astype(np.float32)
    logvar.flat[::97] = 80.0  # beyond the +-50 clip
    return mu, logvar


def _to_jax_layout(a):
    """(B, E, C, D, H, W) -> (B, E, D, H, W, C)."""
    return np.moveaxis(np.asarray(a), 2, -1)


def test_stack_prior_and_clip_match_jax():
    mu, logvar = _experts(0)
    t_mu, t_lv = poe.stack_prior(torch.from_numpy(mu), torch.from_numpy(logvar))
    j_mu, j_lv = jpoe.stack_prior(jnp.asarray(_to_jax_layout(mu)),
                                  jnp.asarray(_to_jax_layout(logvar)))
    assert t_mu.shape == (2, 5, 3, 4, 5, 6)
    np.testing.assert_array_equal(_to_jax_layout(t_mu), np.asarray(j_mu))
    np.testing.assert_array_equal(_to_jax_layout(t_lv), np.asarray(j_lv))
    assert float(t_lv.max()) == poe.LOGVAR_CLIP


@pytest.mark.parametrize("subset", [0, 4, 10, 13, 14])
def test_product_of_experts_matches_jax(subset):
    mu, logvar = poe.stack_prior(*map(torch.from_numpy, _experts(1)))
    keep = subsets.SUBSET_MASKS[subset]
    t_mu, t_lv = poe.product_of_experts(mu, logvar, torch.tensor(keep))
    j_mu, j_lv = jpoe.product_of_experts(jnp.asarray(_to_jax_layout(mu)),
                                         jnp.asarray(_to_jax_layout(logvar)),
                                         jnp.asarray(keep))
    np.testing.assert_allclose(np.moveaxis(t_mu.numpy(), 1, -1), j_mu, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.moveaxis(t_lv.numpy(), 1, -1), j_lv, rtol=1e-6, atol=1e-6)


def test_product_of_experts_per_instance_keep_matches_jax():
    mu, logvar = poe.stack_prior(*map(torch.from_numpy, _experts(2)))
    keep = subsets.SUBSET_MASKS[[3, 11]]  # (B, 4), a different subset per instance
    t_mu, t_lv = poe.product_of_experts(mu, logvar, torch.tensor(keep))
    j_mu, j_lv = jpoe.product_of_experts(jnp.asarray(_to_jax_layout(mu)),
                                         jnp.asarray(_to_jax_layout(logvar)),
                                         jnp.asarray(keep))
    np.testing.assert_allclose(np.moveaxis(t_mu.numpy(), 1, -1), j_mu, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.moveaxis(t_lv.numpy(), 1, -1), j_lv, rtol=1e-6, atol=1e-6)
    # each instance equals the batch-keep product of its own subset
    for b, s in enumerate((3, 11)):
        one_mu, _ = poe.product_of_experts(mu[b:b + 1], logvar[b:b + 1],
                                           torch.tensor(subsets.SUBSET_MASKS[s]))
        torch.testing.assert_close(one_mu, t_mu[b:b + 1], rtol=0, atol=0)


def test_dropped_expert_gets_zero_gradient():
    mu_np, lv_np = _experts(3)
    mu = torch.from_numpy(mu_np).requires_grad_(True)
    logvar = torch.from_numpy(lv_np).requires_grad_(True)
    keep = torch.tensor([True, False, True, False])
    pd_mu, pd_lv = poe.product_of_experts(*poe.stack_prior(mu, logvar), keep)
    (pd_mu.square().sum() + pd_lv.sum()).backward()
    for m in (1, 3):
        assert torch.count_nonzero(mu.grad[:, m]) == 0
        assert torch.count_nonzero(logvar.grad[:, m]) == 0
    assert torch.count_nonzero(mu.grad[:, 0]) > 0

    def loss(mu_j, lv_j):
        a, b = jpoe.product_of_experts(*jpoe.stack_prior(mu_j, lv_j), jnp.asarray(keep.numpy()))
        return jnp.sum(a ** 2) + jnp.sum(b)

    g_mu, g_lv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(_to_jax_layout(mu_np)),
                                                jnp.asarray(_to_jax_layout(lv_np)))
    np.testing.assert_allclose(_to_jax_layout(mu.grad), g_mu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_to_jax_layout(logvar.grad), g_lv, rtol=1e-5, atol=1e-6)


def test_reparametrize():
    mu = torch.randn(2, 3, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    logvar = torch.randn(2, 3, 4, 4, 4, generator=torch.Generator().manual_seed(1))
    assert poe.reparametrize(mu, logvar, deterministic=True) is mu
    j = jpoe.reparametrize(None, jnp.asarray(mu.numpy()), jnp.asarray(logvar.numpy()),
                           deterministic=True)
    np.testing.assert_array_equal(np.asarray(j), mu.numpy())
    z1 = poe.reparametrize(mu, logvar, generator=torch.Generator().manual_seed(7))
    z2 = poe.reparametrize(mu, logvar, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(z1, z2, rtol=0, atol=0)
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(z1, mu + eps * torch.exp(0.5 * logvar))
    with pytest.raises(ValueError):
        poe.reparametrize(mu, logvar)
