"""Evaluation metrics (counterpart of the dice and PSNR part of
`xlstm_hved_tpu/metrics/__init__.py`). Tensors are NCDHW; each metric
returns an fp32 scalar tensor. HD95 and SSIM3D come in a later slice.
"""
from __future__ import annotations

import torch

# nested sigmoid channels; "ET" is the upstream name of the enhancing core
REGION_CHANNEL = {"WT": 0, "TC": 1, "EC": 2, "ET": 2}


def dice_coefficient(pred: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-6) -> torch.Tensor:
    """Hard (> 0.5) dice per sample and channel, averaged."""
    p = (pred > 0.5).float()
    t = target.float()
    dims = tuple(range(2, pred.ndim))
    intersect = (p * t).sum(dims)
    denom = (p + t).sum(dims)
    return ((2 * intersect + epsilon) / (denom + epsilon)).mean()


def dice_region(pred: torch.Tensor, target: torch.Tensor, region: str = "WT",
                mode: str = "sigmoid", epsilon: float = 1e-6) -> torch.Tensor:
    """WT / TC / EC dice: one nested sigmoid channel (mode "sigmoid"), or
    the BraTS regions of argmax label volumes (mode "softmax")."""
    if mode == "sigmoid":
        ch = REGION_CHANNEL[region]
        input_roi = (pred[:, ch] > 0.5).float()
        target_roi = target[:, ch].float()
    else:
        pl, tl = pred.argmax(dim=1), target.argmax(dim=1)
        if region == "WT":
            input_roi, target_roi = (pl > 0).float(), (tl > 0).float()
        elif region == "TC":
            input_roi = ((pl > 0) & (pl != 2)).float()
            target_roi = ((tl > 0) & (tl != 2)).float()
        else:
            input_roi, target_roi = (pl == 3).float(), (tl == 3).float()
    dims = tuple(range(1, input_roi.ndim))
    intersect = (input_roi * target_roi).sum(dims)
    denom = (input_roi + target_roi).sum(dims)
    return ((2 * intersect + epsilon) / (denom + epsilon)).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """10 log10(1 / MSE) on [0, 1] data."""
    mse = torch.mean((pred.float() - target.float()).square())
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
