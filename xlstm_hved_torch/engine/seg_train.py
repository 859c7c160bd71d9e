"""The deep-supervised segmentation train step of nnU-Net v2's trainer
(`nnUNetTrainer`, whose defaults xLSTM-UNet's trainers keep), for the
UxLSTM nets of `models/uxlstm.py`.

One step:
1. the net's forward in train mode: one logits map per decoder head,
   highest resolution first;
2. the deep-supervised loss: nnU-Net's `DC_and_BCE_loss` (BCE with logits
   plus the soft dice of `MemoryEfficientSoftDiceLoss`: sigmoid, the
   background kept, smooth 1e-5, one dice per sample and region, as the
   3d_fullres plan's `batch_dice` false sets it) on each head against the
   region targets at its scale, weighted 1 / 2^i with the lowest head at 0
   and the weights normalised (`DeepSupervisionWrapper`, which skips a head
   of weight 0: its parameters take no gradient and the optimizer leaves
   them where they are);
3. the backward;
4. the gradient norm clipped at `grad_clip` (12), then SGD with Nesterov
   momentum (0.99) and L2 weight decay (3e-5) added to the gradient, at the
   poly learning rate lr * (1 - epoch / num_epochs)^0.9, stepped per epoch
   of `steps_per_epoch` steps (`PolyLRScheduler`).

The step reads nothing back from the device: it returns the loss as a 0-d
device tensor, and the caller decides when to wait for it, as nnU-Net's
`train_step` does when it returns `loss.detach().cpu()`. Each phase is a
`utils.logging.span`: `segtrain.step` around the whole, `segtrain.forward`,
`segtrain.loss`, `segtrain.backward`, `segtrain.sgd` (the clip and the
update).

Departures from nnU-Net:
- precision: the port's policy, not fp16 autocast with a GradScaler. The
  net's convs compute in its compute dtype, cast at the op
  (`build_uxlstm_from_plans(..., dtype=torch.bfloat16)`), the instance
  norms' statistics in fp32, the ViL mixers in fp32 (the fp32 island); the
  parameters, their gradients and the momentum stay fp32, and the loss is
  computed in (at least) fp32 from the logits;
- the step takes a batch and its per-scale targets (`deep_supervision_targets`,
  nnU-Net's `DownsampleSegForDSTransform`): the data loader and its
  augmentation are the caller's;
- one process: no DDP, so the dice needs no all-gather (nor does it with
  `batch_dice` false) and the lowest head's weight is 0, not 1e-6.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.engine.train import poly_schedule
from xlstm_hved_torch.nn.blocks import at_least_fp32
from xlstm_hved_torch.utils.logging import span

# MemoryEfficientSoftDiceLoss's smoothing in nnU-Net's region-based loss
DICE_SMOOTH = 1e-5


@dataclasses.dataclass(frozen=True)
class SegTrainConfig:
    """nnUNetTrainer's optimisation defaults."""

    learning_rate: float = 1e-2
    momentum: float = 0.99
    weight_decay: float = 3e-5
    poly_power: float = 0.9
    num_epochs: int = 1000
    steps_per_epoch: int = 250
    grad_clip: float = 12.0


@dataclasses.dataclass
class SegTrainState:
    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def make_sgd(params, cfg: SegTrainConfig) -> torch.optim.SGD:
    """SGD with Nesterov momentum and L2 weight decay added to the gradient
    (nnUNetTrainer.configure_optimizers). Its learning rate is set per step
    from `poly_schedule`."""
    return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, nesterov=True)


def deep_supervision_scales(pool_op_kernel_sizes: Sequence[Sequence[int]]
                            ) -> List[Tuple[float, ...]]:
    """Each head's scale per axis, highest resolution first: one over the
    cumulative product of the plan's pools, the last stage's left out
    (nnUNetTrainer._get_deep_supervision_scales)."""
    scales = 1.0 / np.cumprod(np.vstack(pool_op_kernel_sizes), axis=0)
    return [tuple(float(v) for v in s) for s in scales[:-1]]


def deep_supervision_weights(n_heads: int) -> List[float]:
    """1 / 2^i per head, the lowest head's set to 0, normalised to sum 1."""
    weights = [1.0 / 2 ** i for i in range(n_heads)]
    weights[-1] = 0.0
    total = sum(weights)
    return [w / total for w in weights]


def deep_supervision_targets(regions: torch.Tensor,
                             scales: Sequence[Sequence[float]]) -> List[torch.Tensor]:
    """(B, R, *spatial) region masks at each scale: nearest-exact
    downsampling (DownsampleSegForDSTransform), the mask itself at scale 1."""
    out = []
    for s in scales:
        if all(v == 1 for v in s):
            out.append(regions)
            continue
        size = [round(n * v) for n, v in zip(regions.shape[2:], s)]
        out.append(F.interpolate(regions.float(), size=size, mode="nearest-exact")
                   .to(regions.dtype))
    return out


def dc_and_bce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE with logits, averaged over every element, minus the soft dice of
    sigmoid(logits) per sample and region, averaged; in at least fp32."""
    x = at_least_fp32(logits)
    target = target.to(x.dtype)
    axes = tuple(range(2, x.ndim))
    p = torch.sigmoid(x)
    intersect = (p * target).sum(axes)
    sum_pred = p.sum(axes)
    sum_gt = target.sum(axes)
    dice = (2 * intersect + DICE_SMOOTH) / torch.clip(sum_gt + sum_pred + DICE_SMOOTH, 1e-8)
    return F.binary_cross_entropy_with_logits(x, target) - dice.mean()


def deep_supervision_loss(outputs: Sequence[torch.Tensor],
                          targets: Sequence[torch.Tensor]) -> torch.Tensor:
    """The weighted sum of `dc_and_bce_loss` over the heads, a head of
    weight 0 left out."""
    if len(outputs) != len(targets):
        raise ValueError(f"{len(outputs)} heads but {len(targets)} targets")
    weights = deep_supervision_weights(len(outputs))
    return sum(w * dc_and_bce_loss(o, t) for o, t, w in zip(outputs, targets, weights)
               if w != 0.0)


def make_ds_train_step(model: nn.Module, cfg: SegTrainConfig) -> Callable:
    """Build train_step(state, x, targets) -> (state, loss). x: (B, C, *patch);
    targets: the (B, R, *spatial) region targets per head, highest
    resolution first (`deep_supervision_targets`). The loss is a 0-d fp32
    device tensor; nothing is read back."""
    schedule = poly_schedule(cfg.learning_rate, cfg.num_epochs, cfg.steps_per_epoch,
                             cfg.poly_power)
    params = list(model.parameters())

    def train_step(state: SegTrainState, x, targets):
        with span("segtrain.step"):
            model.train()
            with span("segtrain.forward"):
                outputs = model(x)
            with span("segtrain.loss"):
                loss = deep_supervision_loss(outputs, targets)
            with span("segtrain.backward"):
                state.opt.zero_grad(set_to_none=True)
                loss.backward()
            with span("segtrain.sgd"):
                torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip)
                for group in state.opt.param_groups:
                    group["lr"] = schedule(state.step)
                state.opt.step()
            state.step += 1
        return state, loss.detach()

    return train_step
