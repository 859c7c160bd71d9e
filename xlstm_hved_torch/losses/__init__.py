"""Loss functions (counterpart of `xlstm_hved_tpu/losses/__init__.py`).

All losses take probabilities (post-sigmoid/softmax) and reduce to fp32
scalars (fp64 in an fp64 run), with the JAX package's epsilons: they cast
to fp32 where the JAX losses do, so bf16 outputs are read in fp32.
Tensors are NCDHW (B, C, D, H, W):
the channel axis is 1 where the JAX functions use the last axis.

Under a data mesh of more than one rank (`parallel/mesh.py`) the losses
that are ratios of sums over the batch (the dice losses, the weighted cross
entropy) add the ranks' partial sums before the ratio, so each is the global
batch's value on every rank, as the sharded JAX step computes it. The batch
means (`l2_loss`, `gan_loss_lsgan`, `boundary_loss`, `bce_loss`, the KL
means) stay local: every rank holds as many rows, so the mean over ranks of
the local means, which the averaged gradients take, is the global mean
already; reducing them here as well would count them twice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_hved_torch.nn.blocks import at_least_fp32
from xlstm_hved_torch.parallel.mesh import global_sums
from xlstm_hved_torch.ops.poe import compute_kld_drop, compute_kld_subsets, kl_divergence

__all__ = [
    "dice_loss",
    "generalized_dice_loss",
    "per_channel_dice",
    "gan_loss_lsgan",
    "boundary_loss",
    "weighted_cross_entropy_loss",
    "bce_loss",
    "l2_loss",
    "kl_divergence",
    "compute_kld_subsets",
    "compute_kld_drop",
]


def _flatten_per_channel(x: torch.Tensor) -> torch.Tensor:
    """(B, C, ...) -> (C, B * spatial), at least fp32."""
    return at_least_fp32(x).transpose(0, 1).reshape(x.shape[1], -1)


def per_channel_dice(pred: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-6) -> torch.Tensor:
    """Soft dice per channel with the V-Net (x^2 + y^2) denominator."""
    p, t = _flatten_per_channel(pred), _flatten_per_channel(target)
    intersect, denom = global_sums((p * t).sum(-1), (p * p).sum(-1) + (t * t).sum(-1))
    return 2.0 * intersect / torch.clamp(denom, min=epsilon)


def dice_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - mean per-channel soft dice."""
    return 1.0 - per_channel_dice(pred, target).mean()


def generalized_dice_loss(pred: torch.Tensor, target: torch.Tensor,
                          epsilon: float = 1e-6) -> torch.Tensor:
    """Inverse-volume-weighted generalised dice loss."""
    p, t = _flatten_per_channel(pred), _flatten_per_channel(target)
    if p.shape[0] == 1:
        p, t = torch.cat([p, 1.0 - p]), torch.cat([t, 1.0 - t])
    w, intersect, denom = global_sums(t.sum(-1), (p * t).sum(-1), (p + t).sum(-1))
    w = 1.0 / torch.clamp(w * w, min=epsilon)
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    intersect = intersect * w
    denom = torch.clamp(denom * w, min=epsilon)
    return 1.0 - 2.0 * intersect.sum() / denom.sum()


def gan_loss_lsgan(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """LSGAN: mean squared distance to the constant 1 (real) or 0 (fake)."""
    return torch.mean((at_least_fp32(pred) - (1.0 if target_is_real else 0.0)).square())


def boundary_loss(probs: torch.Tensor, gt_sdf: torch.Tensor) -> torch.Tensor:
    """Mean of probabilities times the ground truth's signed distance map."""
    return torch.mean(at_least_fp32(probs) * at_least_fp32(gt_sdf))


def bce_loss(pred: torch.Tensor, target: torch.Tensor,
             epsilon: float = 1e-7) -> torch.Tensor:
    """Sum over channels of the per-channel BCE on probabilities."""
    p = torch.clamp(at_least_fp32(pred), epsilon, 1.0 - epsilon)
    t = at_least_fp32(target)
    dims = (0,) + tuple(range(2, pred.ndim))
    per_ch = -torch.mean(t * torch.log(p) + (1 - t) * torch.log1p(-p), dim=dims)
    return per_ch.sum()


def weighted_cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross entropy with inverse-frequency class weights, held constant,
    normalised as `F.cross_entropy(weight=w)` is: sum(w_y nll) / sum(w_y).
    `target` is one-hot over the channel axis."""
    flat = _flatten_per_channel(logits).detach()
    neg, pos = global_sums((1.0 - flat).sum(-1), flat.sum(-1))
    weights = neg / pos
    labels = target.argmax(dim=1)
    nll = -torch.gather(F.log_softmax(at_least_fp32(logits), dim=1), 1, labels[:, None])[:, 0]
    w = weights[labels]
    num, den = global_sums((w * nll).sum(), w.sum())
    return num / den


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((at_least_fp32(pred) - at_least_fp32(target)).square())
