"""Product-of-Experts latent fusion and reparameterization
(counterpart of `xlstm_hved_tpu/ops/poe.py`).

Expert stacks are (B, E, C, D, H, W): axis 1 indexes the experts, with the
standard-normal prior at expert 0 and the modalities at 1..4. The subset is
a boolean keep-mask over the modality experts; multiplying by the constant
0/1 mask removes a dropped expert from both sums and from the gradient.
The KL terms of the training objective close the module.
"""
from __future__ import annotations

from typing import Optional

import torch

from xlstm_hved_torch.parallel.mesh import sample_rows

LOGVAR_CLIP = 50.0
POE_EPS = 1e-8


def clip_logvar(logvar: torch.Tensor, limit: float = LOGVAR_CLIP) -> torch.Tensor:
    """Clamp logvars to ±limit so exp(logvar) stays finite."""
    return torch.clamp(logvar, -limit, limit)


def stack_prior(mod_mu: torch.Tensor, mod_logvar: torch.Tensor):
    """Prepend the N(0, 1) prior to (B, M, ...) per-modality Gaussians.

    Returns (B, M+1, ...) stacks with mu = logvar = 0 at expert 0 and the
    modality logvars clipped.
    """
    mu = torch.cat([torch.zeros_like(mod_mu[:, :1]), mod_mu], dim=1)
    logvar = torch.cat([torch.zeros_like(mod_logvar[:, :1]),
                        clip_logvar(mod_logvar)], dim=1)
    return mu, logvar


def product_of_experts(mu: torch.Tensor, logvar: torch.Tensor,
                       keep: torch.Tensor, eps: float = POE_EPS):
    """Precision-weighted Gaussian product over the kept experts + prior.

    Args:
        mu, logvar: (B, E, ...) expert parameters, prior at expert 0.
        keep: (B, 4) or (4,) bool, True where the modality expert is kept.
            The prior is always kept.
    Returns:
        (pd_mu, pd_logvar), each (B, ...).
    """
    if keep.ndim == 1:
        keep = keep[None, :]
    keep = keep.to(device=mu.device).bool()
    if keep.shape[0] == 1 and mu.shape[0] != 1:
        keep = keep.expand(mu.shape[0], keep.shape[1])
    prior = torch.ones((keep.shape[0], 1), dtype=torch.bool, device=mu.device)
    keep_e = torch.cat([prior, keep], dim=1)
    keep_e = keep_e.reshape(keep_e.shape + (1,) * (mu.ndim - 2)).to(mu.dtype)

    var = torch.exp(logvar) + eps
    precision = keep_e / var
    sum_t = precision.sum(dim=1)
    pd_mu = (mu * precision).sum(dim=1) / sum_t
    pd_logvar = -torch.log(sum_t)
    return pd_mu, pd_logvar


def reparametrize(mu: torch.Tensor, logvar: torch.Tensor,
                  deterministic: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mu + eps * exp(logvar / 2) with eps ~ N(0, 1) drawn from `generator`;
    the mean itself when `deterministic`. Under a data mesh eps is drawn at
    the global batch shape and this rank keeps its rows (`sample_rows`), so
    N ranks draw what one process draws at the global batch."""
    if deterministic:
        return mu
    if generator is None:
        raise ValueError("reparametrize needs a torch.Generator when sampling")
    eps = sample_rows(lambda shape: torch.randn(shape, generator=generator, dtype=mu.dtype,
                                                device=mu.device), mu.shape)
    return mu + eps * torch.exp(0.5 * logvar)


def kl_divergence(mu1: torch.Tensor, logvar1: torch.Tensor,
                  mu2: Optional[torch.Tensor] = None,
                  logvar2: Optional[torch.Tensor] = None,
                  eps: float = 1e-8) -> torch.Tensor:
    """Mean over all elements of KL(N(mu1, var1) || N(mu2, var2)); the
    standard normal when mu2 is None. A batch mean, so under a data mesh it
    stays this rank's: the averaged gradients make it the global one."""
    if mu2 is None:
        return 0.5 * torch.mean(-1.0 - logvar1 + torch.exp(logvar1) + mu1.square())
    var1, var2 = torch.exp(logvar1), torch.exp(logvar2)
    return 0.5 * torch.mean(-1.0 + logvar2 - logvar1
                            + (var1 + (mu1 - mu2).square()) / (var2 + eps))


def compute_kld_subsets(mu: torch.Tensor, logvar: torch.Tensor,
                        subset_keeps: torch.Tensor) -> torch.Tensor:
    """Mean over subsets of KL(PoE(subset) || N(0, 1)) for one level.
    mu, logvar: (B, 5, C, D, H, W) expert stacks (prior at 0);
    subset_keeps: (S, 4) bool keep-masks, one subset per row."""
    klds = [kl_divergence(*product_of_experts(mu, logvar, keep))
            for keep in torch.as_tensor(subset_keeps).bool()]
    return torch.stack(klds).mean()


def compute_kld_drop(mu: torch.Tensor, logvar: torch.Tensor,
                     drop: torch.Tensor) -> torch.Tensor:
    """Instance-missing KL: the PoE over each instance's kept modalities
    against the prior. drop: (B, 4) bool, True = missing."""
    return kl_divergence(*product_of_experts(mu, logvar, ~torch.as_tensor(drop).bool()))
