"""Plain reference of one adversarial G + D training step and of the
15-subset sweep, over the modules of `reference/model.py`.

The step, in order: the subset (a size uniform in 1..3, then a member of
that size's bucket, drawn from the step's CPU generator); G's objective from
two train-mode forwards (all modalities, then the subset), with the latent
noise drawn from the step's device generator, level by level, the full
forward's first; dice + subset dice + beta * recon MSE + beta * the mean over
levels of the subset KL + alpha * LSGAN(D(seg, attention-weighted recon),
real); G's gradient; Adam with L2 decay; then D's objective on the detached
outputs with D as it was, its gradient and its Adam step. The learning rate
is the poly schedule of the configuration.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List

import torch

from perfbench.reference.model import product_of_experts

# the 15 non-empty subsets of 4 modalities, by size then lexicographically
SUBSETS = [s for r in range(1, 5) for s in itertools.combinations(range(4), r)]
SIZE_BUCKETS = {1: (0, 4), 2: (4, 10), 3: (10, 14), 4: (14, 15)}


def keep_mask(index: int, device=None) -> torch.Tensor:
    keep = torch.zeros(4, dtype=torch.bool)
    keep[list(SUBSETS[index])] = True
    return keep.to(device)


def draw_subset(generator: torch.Generator) -> int:
    size = int(torch.randint(1, 4, (), generator=generator))
    lo, hi = SIZE_BUCKETS[size]
    return lo + int(float(torch.rand((), generator=generator)) * (hi - lo))


def dice_loss(pred, target, eps=1e-6):
    p = pred.transpose(0, 1).reshape(pred.shape[1], -1)
    t = target.transpose(0, 1).reshape(target.shape[1], -1)
    dice = 2.0 * (p * t).sum(-1) / torch.clamp((p * p).sum(-1) + (t * t).sum(-1), min=eps)
    return 1.0 - dice.mean()


def lsgan(pred, real: bool):
    return torch.mean((pred - (1.0 if real else 0.0)).square())


def kl_subset(mu, logvar, keep):
    pd_mu, pd_logvar = product_of_experts(mu, logvar, keep)
    return 0.5 * torch.mean(-1.0 - pd_logvar + torch.exp(pd_logvar) + pd_mu.square())


def region_weight(seg):
    """The innermost of WT, TC, ET above 0.5 gives its probability, else 0."""
    wt, tc, et = seg[:, 0], seg[:, 1], seg[:, 2]
    w = torch.where(wt > 0.5, wt, torch.zeros_like(wt))
    w = torch.where(tc > 0.5, tc, w)
    return torch.where(et > 0.5, et, w)


def poly_lr(train: dict, step: int) -> float:
    epoch = step // train["steps_per_epoch"]
    left = max(1.0 - epoch / train["num_epochs"], 0.0)
    return train["learning_rate"] * left ** train["poly_power"]


class Adam:
    """Adam with the decay added to the gradient before the moments."""

    def __init__(self, params: List[torch.Tensor], weight_decay: float,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params, self.wd, self.betas, self.eps = params, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float):
        self.t += 1
        b1, b2 = self.betas
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g + self.wd * p
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def _noise(shapes, generator):
    return [torch.randn(s, generator=generator, device=generator.device) for s in shapes]


def latent_shapes(model, x):
    """The per-level latent shapes of a batch x: level lv's latent has
    lat[lv] channels at the input size over 2^(lv+1)."""
    B = x.shape[0]
    return [(B, model.lat[lv], *(s // 2 ** (lv + 1) for s in x.shape[2:]))
            for lv in range(model.levels)]


class ReferenceStep:
    """G, D, their Adam states and the step counter; `step(x, mask, rng,
    latent_rng)` runs one training step and returns its losses."""

    def __init__(self, model, disc, train: dict):
        self.model, self.disc, self.train = model, disc, train
        self.g_names = [n for n, _ in model.named_parameters()]
        self.d_names = [n for n, _ in disc.named_parameters()]
        self.g_params = [p for _, p in model.named_parameters()]
        self.d_params = [p for _, p in disc.named_parameters()]
        self.opt_g = Adam(self.g_params, train["weight_decay"])
        self.opt_d = Adam(self.d_params, train["weight_decay"])
        self.count = 0

    def g_objective(self, x, mask, keep, noise_f, noise_m):
        alpha, beta = self.train["weight_adv"], self.train["weight_vae"]
        self.model.train()
        out_f = self.model(x, torch.ones(4, dtype=torch.bool), noise_f)
        out_m = self.model(x, keep, noise_m)
        dice = dice_loss(out_f.seg, mask)
        m_dice = dice_loss(out_m.seg, mask)
        recon = torch.mean((out_m.recon - x).square())
        kld = torch.stack([kl_subset(mu, lv, keep)
                           for mu, lv in zip(out_m.mu, out_m.logvar)]).mean()
        f_seg, m_seg = out_f.seg.detach(), out_m.seg.detach()
        atten_f = out_f.recon.detach() * (1.0 + region_weight(f_seg)[:, None])
        atten_m = out_m.recon * (1.0 + region_weight(m_seg)[:, None])
        g_gan = lsgan(self.disc(torch.cat([out_m.seg, atten_m], dim=1)), True)
        loss = dice + m_dice + beta * recon + beta * kld + alpha * g_gan
        losses = dict(loss=loss, dice=dice, m_dice=m_dice, recon=recon, kld=kld, g_gan=g_gan)
        pairs = (torch.cat([m_seg, atten_m.detach()], dim=1), torch.cat([f_seg, atten_f], dim=1))
        return loss, losses, pairs

    def d_objective(self, fake, real):
        alpha = self.train["weight_adv"]
        return alpha * (lsgan(self.disc(fake), False) + lsgan(self.disc(real), True)) * 0.5

    def draws(self, x, rng: torch.Generator, latent_rng: torch.Generator):
        """A step's draws: the subset, its keep mask, the latent noise of the
        full forward and of the subset forward."""
        subset = draw_subset(rng)
        shapes = latent_shapes(self.model, x)
        noise_f = _noise(shapes, latent_rng)
        return subset, keep_mask(subset), noise_f, _noise(shapes, latent_rng)

    @torch.no_grad()
    def losses(self, x, mask, rng: torch.Generator, latent_rng: torch.Generator):
        """The first step's forwards and loss terms, with no update."""
        subset, keep, noise_f, noise_m = self.draws(x, rng, latent_rng)
        _, losses, (fake, real) = self.g_objective(x, mask, keep, noise_f, noise_m)
        out = {k: float(v) for k, v in losses.items()}
        out["loss_d"] = float(self.d_objective(fake, real))
        out["subset_idx"] = subset
        return out

    def step(self, x, mask, rng: torch.Generator, latent_rng: torch.Generator) -> Dict[str, float]:
        subset, keep, noise_f, noise_m = self.draws(x, rng, latent_rng)
        lr = poly_lr(self.train, self.count)
        self.disc.requires_grad_(False)
        try:
            loss, losses, (fake, real) = self.g_objective(x, mask, keep, noise_f, noise_m)
            grads = torch.autograd.grad(loss, self.g_params, allow_unused=True)
        finally:
            self.disc.requires_grad_(True)
        self.opt_g.step([torch.zeros_like(p) if g is None else g
                         for p, g in zip(self.g_params, grads)], lr)
        loss_d = self.d_objective(fake, real)
        grads_d = torch.autograd.grad(loss_d, self.d_params)
        self.opt_d.step(list(grads_d), lr)
        self.count += 1
        out = {k: float(v.detach()) for k, v in losses.items()}
        out["loss_d"] = float(loss_d.detach())
        out["subset_idx"] = subset
        return out


@torch.no_grad()
def sweep(model, x, subsets=range(15)):
    """The plain 15-subset sweep at patch = volume: per subset, the masked
    volume through the eval-mode model with the latent means. Yields
    (subset, seg, recon)."""
    model.eval()
    for s in subsets:
        keep = keep_mask(s, x.device)
        out = model(x * keep.to(x.dtype).reshape(1, -1, 1, 1, 1), keep.cpu())
        yield s, out.seg, out.recon


def first_gradient(opt: Adam) -> List[torch.Tensor]:
    """The gradient Adam took at its first step (decay included), from its
    first moment."""
    return [m / (1 - opt.betas[0]) for m in opt.m]


def leaf_norms(tensors) -> List[float]:
    return [math.sqrt(float(t.double().square().sum())) for t in tensors]
