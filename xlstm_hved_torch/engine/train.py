"""The adversarial train step (G + D) and the evaluation step (counterpart
of `xlstm_hved_tpu/engine/train.py`).

One step, in the JAX step's order:
1. draw the modality subset (a size in 1..3, then a subset of that size);
2. the generator objective: two train-mode G forwards (all modalities, then
   the drawn subset; the second starts from the BatchNorm running statistics
   the first moved), dice + missing-modality dice + beta * recon + beta * the
   mean over levels of the subset KL + alpha * the LSGAN loss of D on
   concat(seg, attention-weighted recon) (+ the optional SDM boundary term).
   The region weights and the all-modality branch are detached; the
   drawn-subset recon reaches D live. D's parameters take no gradient from
   this loss;
3. the freeze mask on the gradient and on the update;
4. the G update: Adam with L2 weight decay added to the gradient before the
   moments (torch.optim.Adam's weight_decay, as optax.add_decayed_weights +
   adam) and the poly learning rate stepped per epoch;
5. the D step on the detached outputs, with D as it was before the step;
6. the metrics.

Data parallelism: inside `with mesh:` (`parallel/mesh.py`) N ranks at a
per-rank batch b compute what one process computes at batch N * b, as the
JAX steps sharded over a mesh do. The subset draw is the same on every rank
(the same seed, the same draws per step); the latent noise is drawn at the
global batch shape and each rank keeps its rows; BatchNorm and the dice
terms reduce over the global batch; after each backward the G and D
gradients are averaged over the ranks (an explicit all-reduce: the
gradients are taken with torch.autograd.grad, which DistributedDataParallel's
hooks do not see), and the metrics are averaged, so every rank reports the
global ones. With no mesh, or one rank, the step is the one-process code.

The pretrain step (`make_pretrain_step`) trains the recon decoders alone:
seg branch off, BatchNorm on its running statistics, MSE recon + beta * KL,
with the seg decoders frozen (`freeze_mask_for`).

Each phase of a step is a `utils.logging.span`: `train.step` around the
whole, `train.g_forward` (the G objective), `train.g_backward` and
`train.g_adam` (the masked update, shared with the pretrain step),
`train.d_forward`, `train.d_backward`, `train.d_adam`.

Randomness comes from the state's generators: subset draws from a CPU
generator, the latent noise from one on the model's device. The G and D
forwards run on whatever device the modules are on; the mLSTM goes through
the CUDA kernels there and through the plain scan on the CPU. They run in
the modules' own compute dtypes (G's `compute_dtype`, D's `dtype`; the
losses read their outputs in fp32), while the parameters, their gradients
and the Adam state stay fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.losses import (boundary_loss, compute_kld_subsets, dice_loss,
                                     gan_loss_lsgan, l2_loss)
from xlstm_hved_torch.metrics import dice_coefficient, dice_region, psnr
from xlstm_hved_torch.nn.init_schemes import INIT_SCHEMES, default_init
from xlstm_hved_torch.parallel.mesh import average_gradients, average_metrics
from xlstm_hved_torch.utils.logging import span
from xlstm_hved_torch.utils.subsets import sample_subset_index, subset_mask

# channels of the discriminator input: 3 seg + 4 attention-weighted recon
DISC_IN_CHANNELS = 7


@dataclasses.dataclass
class TrainState:
    model: nn.Module                 # G, an HVEDFusionNet
    disc: nn.Module                  # D, a Discriminator
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    rng: torch.Generator             # CPU: subset draws
    latent_rng: torch.Generator      # model's device: reparametrisation noise
    step: int = 0


def poly_schedule(base_lr: float, num_epochs: int, steps_per_epoch: int,
                  power: float = 0.9) -> Callable[[int], float]:
    """lr * (1 - epoch / E)^power with epoch = count // steps_per_epoch."""

    def schedule(count: int) -> float:
        frac = 1.0 - (count // steps_per_epoch) / num_epochs
        return base_lr * max(frac, 0.0) ** power

    return schedule


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with L2 weight decay added to the gradient before the moments
    (not decoupled AdamW). Its learning rate is set per step from
    `poly_schedule`."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay)


def nested_region_weight(seg: torch.Tensor) -> torch.Tensor:
    """(B, 3, D, H, W) WT/TC/ET probabilities -> (B, D, H, W) weight: the
    innermost region above 0.5 gives its probability, else 0."""
    wt, tc, et = seg[:, 0], seg[:, 1], seg[:, 2]
    w = torch.where(wt > 0.5, wt, torch.zeros_like(wt))
    w = torch.where(tc > 0.5, tc, w)
    return torch.where(et > 0.5, et, w)


def create_train_state(model: nn.Module, disc: nn.Module, cfg: TrainConfig, seed: int,
                       sample: torch.Tensor, steps_per_epoch: int = 1,
                       init_scheme: str = "default") -> TrainState:
    """Draw G's and D's weights, put both on the sample batch's device and
    build both optimizers. init_scheme: "default" (the flax initialisers)
    or "reference" (the upstream init_weights, drawn over the default).
    Weights loaded into the modules afterwards (a checkpoint, a transplant)
    are the ones the optimizers step. The sample batch (B, 4, D, H, W) fixes
    the device and must fit D. `steps_per_epoch` is the JAX signature's; the
    schedule takes it from make_train_step."""
    del steps_per_epoch
    if init_scheme not in INIT_SCHEMES:
        raise ValueError(f"unknown init_scheme {init_scheme!r}")
    gen = torch.Generator().manual_seed(seed)
    for module in (model, disc):
        default_init(module, gen)
        if init_scheme != "default":
            INIT_SCHEMES[init_scheme](module, gen)
    disc.check_input(sample.shape[2:])
    device = sample.device
    model.to(device)
    disc.to(device)
    latent_rng = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(model=model, disc=disc,
                      opt_g=make_optimizer(model.parameters(), cfg),
                      opt_d=make_optimizer(disc.parameters(), cfg),
                      rng=torch.Generator().manual_seed(seed), latent_rng=latent_rng)


def mean_subset_kld(out, keep: torch.Tensor) -> torch.Tensor:
    """The mean over levels of the subset KL of the experts, as the JAX
    steps take it: a stack of one term per level, averaged. A model without
    experts (the fusion and plain multi-stream arms, FusionUNet3D) has no
    term to stack; the JAX step's `jnp.stack` raises a ValueError there, and
    so does this, so neither package trains such a model."""
    if not out.mu:
        raise ValueError("need at least one array to stack: the model has no experts, "
                         "and the objective averages one KL term per expert level")
    return torch.stack([compute_kld_subsets(mu, lv, keep[None])
                        for mu, lv in zip(out.mu, out.logvar)]).mean()


def _g_objective(model: nn.Module, disc: nn.Module, cfg: TrainConfig) -> Callable:
    """The generator loss shared by make_train_step and make_grad_fn:
    (x, mask, keep, generator, deterministic, sdm) -> (loss, aux). Runs G in
    train mode; D must not require grad while it runs."""
    alpha, beta = cfg.weight_adv, cfg.weight_vae

    def loss_g(x, mask, keep, generator=None, deterministic=False, sdm=None):
        model.train()
        out_f = model(x, recon=True, deterministic=deterministic, generator=generator)
        out_m = model(x, keep=keep, recon=True, deterministic=deterministic,
                      generator=generator)
        dice = dice_loss(out_f.seg, mask)
        m_dice = dice_loss(out_m.seg, mask)
        recon = l2_loss(out_m.recon, x)
        kld = mean_subset_kld(out_m, keep)
        f_seg, m_seg = out_f.seg.detach(), out_m.seg.detach()
        atten_f = out_f.recon.detach() * (1.0 + nested_region_weight(f_seg)[:, None])
        atten_m = out_m.recon * (1.0 + nested_region_weight(m_seg)[:, None])
        g_gan = gan_loss_lsgan(disc(torch.cat([out_m.seg, atten_m], dim=1)), True)
        loss = dice + m_dice + beta * recon + beta * kld + alpha * g_gan
        bd = torch.zeros((), device=x.device)
        if sdm is not None:
            bd = boundary_loss(out_f.seg, sdm) + boundary_loss(out_m.seg, sdm)
            loss = loss + cfg.weight_bd * bd
        losses = dict(loss=loss, dice=dice, m_dice=m_dice, recon=recon, kld=kld,
                      g_gan=g_gan, bd=bd)
        aux = dict(f_seg=f_seg, m_seg=m_seg, atten_f=atten_f, atten_m=atten_m.detach(),
                   losses={k: v.detach() for k, v in losses.items()})
        return loss, aux

    return loss_g


def _grads(loss, params):
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_grad_fn(model: nn.Module, disc: nn.Module, cfg: TrainConfig) -> Callable:
    """(x, mask, keep, generator=None, deterministic=False) -> (loss,
    {name: gradient}): the raw generator gradients before the optimizer,
    for comparisons, averaged over the ranks under a data mesh. Like the
    JAX function it leaves the module state as it was: the BatchNorm
    running statistics are restored afterwards."""
    loss_g = _g_objective(model, disc, cfg)

    def grad_fn(x, mask, keep, generator=None, deterministic=False):
        stats = {n: b.clone() for n, b in model.named_buffers()}
        disc.requires_grad_(False)
        try:
            loss, _ = loss_g(x, mask, keep, generator, deterministic)
            names, params = zip(*model.named_parameters())
            grads = average_gradients(_grads(loss, list(params)))
            loss = average_metrics({"loss": loss.detach()})["loss"]
        finally:
            disc.requires_grad_(True)
            with torch.no_grad():
                for n, b in model.named_buffers():
                    b.copy_(stats[n])
        return loss.detach(), dict(zip(names, grads))

    return grad_fn


def make_loss_d(disc: nn.Module, cfg: TrainConfig) -> Callable:
    """The discriminator objective on the G step's detached outputs:
    alpha * (LSGAN(D(drawn-subset pair), fake) + LSGAN(D(all-modality
    pair), real)) / 2, where a pair is concat(seg, attention-weighted
    recon)."""

    def loss_d(aux):
        pred_fake = disc(torch.cat([aux["m_seg"], aux["atten_m"]], dim=1))
        pred_real = disc(torch.cat([aux["f_seg"], aux["atten_f"]], dim=1))
        return cfg.weight_adv * (gan_loss_lsgan(pred_fake, False)
                                 + gan_loss_lsgan(pred_real, True)) * 0.5

    return loss_d


def _step(opt: torch.optim.Optimizer, params, grads, lr: float):
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)


def _masked_g_update(model: nn.Module, freeze_mask: Optional[Mapping[str, float]]):
    """update(opt, loss, lr): the G gradients of `loss` times the freeze mask,
    one optimizer step, and the parameters with mask 0 put back where they
    were (the JAX steps mask the update too: the weight decay would move
    them)."""
    names, params = zip(*model.named_parameters())
    params = list(params)
    scale = [float((freeze_mask or {}).get(n, 1.0)) for n in names]
    frozen = [p for p, m in zip(params, scale) if m == 0.0]

    def update(opt: torch.optim.Optimizer, loss, lr: float):
        with span("train.g_backward"):
            grads = average_gradients(_grads(loss, params))
        with span("train.g_adam"):
            grads = [g if m == 1.0 else g * m for g, m in zip(grads, scale)]
            kept = [p.detach().clone() for p in frozen]
            _step(opt, params, grads, lr)
            with torch.no_grad():
                for p, old in zip(frozen, kept):
                    p.copy_(old)

    return update


def make_train_step(model: nn.Module, disc: nn.Module, cfg: TrainConfig,
                    steps_per_epoch: int = 1,
                    freeze_mask: Optional[Mapping[str, float]] = None) -> Callable:
    """Build train_step(state, x, mask, sdm=None) -> (state, metrics).
    x: (B, 4, D, H, W); mask: (B, 3, D, H, W). `freeze_mask` maps G
    parameter names to 0/1 (missing names are 1): a 0 zeroes the gradient
    and keeps the parameter where it was (Adam's moments still move, as
    the JAX step's masked update leaves them). Metrics are 0-d tensors on
    the device, and the drawn subset index."""
    schedule = poly_schedule(cfg.learning_rate, cfg.num_epochs, steps_per_epoch,
                             cfg.poly_power)
    loss_g = _g_objective(model, disc, cfg)
    loss_d_fn = make_loss_d(disc, cfg)
    update_g = _masked_g_update(model, freeze_mask)
    params_d = list(disc.parameters())

    def train_step(state: TrainState, x, mask, sdm=None):
        with span("train.step"):
            subset_idx = sample_subset_index(state.rng, 1, 3)
            keep = subset_mask(subset_idx, x.device)
            lr = schedule(state.step)

            disc.requires_grad_(False)
            try:
                with span("train.g_forward"):
                    loss, aux = loss_g(x, mask, keep, state.latent_rng, False, sdm)
                update_g(state.opt_g, loss, lr)
            finally:
                disc.requires_grad_(True)
            del loss

            with span("train.d_forward"):
                loss_d = loss_d_fn(aux)
            with span("train.d_backward"):
                grads_d = average_gradients(_grads(loss_d, params_d))
            with span("train.d_adam"):
                _step(state.opt_d, params_d, grads_d, lr)
            del grads_d

            metrics = dict(aux["losses"])
            metrics["loss_d"] = loss_d.detach()
            metrics["train_dice"] = dice_coefficient(aux["f_seg"], mask)
            metrics["wt_dice"] = dice_region(aux["f_seg"], mask, "WT")
            metrics["tc_dice"] = dice_region(aux["f_seg"], mask, "TC")
            metrics["ec_dice"] = dice_region(aux["f_seg"], mask, "EC")
            metrics = average_metrics(metrics)
            metrics["subset_idx"] = subset_idx
            state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module) -> Callable:
    """eval_step(x, x_missing, mask) -> metrics: the all-modality pass and
    the instance-missing pass (presence inferred from all-zero channels),
    eval-mode BatchNorm, deterministic latents, dice per region and recon
    PSNR on both. The module's train/eval mode is restored afterwards."""

    @torch.no_grad()
    def eval_step(x, x_missing, mask) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            out = model(x, recon=True, deterministic=True)
            out_m = model(x_missing, instance_missing=True, recon=True, deterministic=True)
        finally:
            model.train(was_training)
        return average_metrics(dict(
            vloss=dice_loss(out.seg, mask),
            dice=dice_coefficient(out.seg, mask),
            wt_dice=dice_region(out.seg, mask, "WT"),
            tc_dice=dice_region(out.seg, mask, "TC"),
            ec_dice=dice_region(out.seg, mask, "EC"),
            wt_dice_m=dice_region(out_m.seg, mask, "WT"),
            tc_dice_m=dice_region(out_m.seg, mask, "TC"),
            ec_dice_m=dice_region(out_m.seg, mask, "EC"),
            psnr_f=psnr(out.recon, x),
            psnr_m=psnr(out_m.recon, x),
        ))

    return eval_step


def pretrain_objective(model: nn.Module, cfg: TrainConfig) -> Callable:
    """The pretrain loss (x, keep, generator=None, deterministic=False) ->
    (loss, {loss, recon, kld}): one drawn-subset forward with the seg branch
    off and BatchNorm on its running statistics (the JAX step's train=False;
    gradients still flow), MSE recon + beta * the mean over levels of the
    subset KL."""

    def loss_fn(x, keep, generator=None, deterministic=False):
        model.eval()
        out = model(x, keep=keep, seg=False, recon=True, deterministic=deterministic,
                    generator=generator)
        recon = l2_loss(out.recon, x)
        kld = mean_subset_kld(out, keep)
        loss = recon + cfg.weight_vae * kld
        return loss, dict(loss=loss.detach(), recon=recon.detach(), kld=kld.detach())

    return loss_fn


def make_pretrain_step(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1,
                       freeze_mask: Optional[Mapping[str, float]] = None) -> Callable:
    """Build pretrain_step(state, x) -> (state, metrics): the subset drawn
    as the train step draws it, `pretrain_objective`, and the masked Adam
    update of G (D is not touched). Parameters the loss does not reach get a
    zero gradient, so the weight decay still moves them, as optax's does."""
    schedule = poly_schedule(cfg.learning_rate, cfg.num_epochs, steps_per_epoch,
                             cfg.poly_power)
    loss_fn = pretrain_objective(model, cfg)
    update_g = _masked_g_update(model, freeze_mask)

    def pretrain_step(state: TrainState, x):
        keep = subset_mask(sample_subset_index(state.rng, 1, 3), x.device)
        loss, metrics = loss_fn(x, keep, state.latent_rng)
        update_g(state.opt_g, loss, schedule(state.step))
        state.step += 1
        return state, average_metrics(metrics)

    return pretrain_step


def freeze_mask_for(model: nn.Module, substrings: Tuple[str, ...]) -> Dict[str, float]:
    """{parameter name: 0.0 where any substring occurs in the name, else
    1.0} over `named_parameters()`, for the steps' `freeze_mask`."""
    return {name: 0.0 if any(s in name for s in substrings) else 1.0
            for name, _ in model.named_parameters()}
