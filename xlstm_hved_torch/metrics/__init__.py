"""Evaluation metrics (counterpart of the dice, IoU, PSNR and SSIM part of
`xlstm_hved_tpu/metrics/__init__.py`). Tensors are NCDHW; each metric
returns an fp32 scalar tensor. HD95 comes with the evaluation CLI.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def mean_iou(pred: torch.Tensor, target: torch.Tensor,
             epsilon: float = 1e-8) -> torch.Tensor:
    """Per-class IoU averaged over classes and batch; a multi-channel
    prediction is one-hot of its argmax, a one-channel one thresholded."""
    n_classes = pred.shape[1]
    if n_classes == 1:
        binary = (pred > 0.5).float()
    else:
        binary = F.one_hot(pred.argmax(dim=1), n_classes).movedim(-1, 1).float()
    t = target.float()
    dims = tuple(range(2, pred.ndim))
    inter = (binary * t).sum(dims)
    union = torch.clamp(torch.maximum(binary, t).sum(dims), min=epsilon)
    return (inter / union).mean()


def ssim3d(pred: torch.Tensor, target: torch.Tensor, window: int = 7,
           data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM with a uniform window^3 mean filter, VALID (no padding),
    per channel. pred, target: (B, C, D, H, W)."""
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    p, t = pred.float(), target.float()

    def unif(x):
        return F.avg_pool3d(x, window, stride=1)

    mu_p, mu_t = unif(p), unif(t)
    sig_p = unif(p * p) - mu_p ** 2
    sig_t = unif(t * t) - mu_t ** 2
    sig_pt = unif(p * t) - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * sig_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (sig_p + sig_t + c2)
    return (num / den).mean()
