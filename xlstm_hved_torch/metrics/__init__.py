"""Evaluation metrics (counterpart of `xlstm_hved_tpu/metrics/__init__.py`).

Dice, IoU, PSNR and SSIM take NCDHW tensors and return fp32 tensors on
their device. HD95 runs on the host on numpy masks (scipy, imported when
called), with the JAX package's edge kernels and sentinels.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from xlstm_hved_torch.parallel.mesh import data_mesh, global_sums

HD95_SENTINEL = 373.13  # about the BraTS volume's diagonal

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


def dice_regions(pred: torch.Tensor, target: torch.Tensor,
                 epsilon: float = 1e-6) -> torch.Tensor:
    """`dice_region` of the three nested sigmoid channels at once: pred
    (..., B, 3, D, H, W) against target (B, 3, D, H, W) -> (..., 3), each
    entry bitwise `dice_region(pred[...], target, region)` (the counts are
    exact in fp32 below 2^24 voxels)."""
    p = (pred > 0.5).float()
    t = target.float()
    dims = (-3, -2, -1)
    intersect = (p * t).sum(dims)
    denom = (p + t).sum(dims)
    return ((2 * intersect + epsilon) / (denom + epsilon)).mean(-2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """10 log10(1 / MSE) on [0, 1] data; under a data mesh of more than one
    rank the global batch's MSE (the ranks' sums, then the ratio)."""
    err = (pred.float() - target.float()).square()
    if data_mesh() is None:
        mse = torch.mean(err)
    else:
        total, count = global_sums(err.sum().reshape(1), err.new_full((1,), err.numel()))
        mse = (total / count)[0]
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


# ---------------- host-side HD95 ----------------

# The JAX package's three edge kernels verbatim: X is a true 3D Sobel, but Y
# smooths z with [1, 1, 1] and Z is the all-ones Prewitt form; they are NOT
# transposes of X. They decide which voxels count as surface, hence HD95.
_SOBEL_X = np.array(
    [[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
     [[-2, 0, 2], [-4, 0, 4], [-2, 0, 2]],
     [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]], dtype=np.float32)
_SOBEL_Y = np.array(
    [[[-1, -2, -1], [0, 0, 0], [1, 2, 1]],
     [[-1, -2, -1], [0, 0, 0], [1, 2, 1]],
     [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]], dtype=np.float32)
_SOBEL_Z = np.array(
    [[[-1, -1, -1], [-1, -1, -1], [-1, -1, -1]],
     [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
     [[1, 1, 1], [1, 1, 1], [1, 1, 1]]], dtype=np.float32)


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boolean (D, H, W): the voxels where any of the three edge kernels
    responds to the binary mask (zero padding)."""
    from scipy.ndimage import convolve

    mask = mask.astype(np.float32)
    edges = np.zeros(mask.shape, dtype=bool)
    for kern in (_SOBEL_X, _SOBEL_Y, _SOBEL_Z):
        edges |= np.abs(convolve(mask, kern, mode="constant")) > 0
    return edges


def _hd95_surfaces(e1: np.ndarray, e2: np.ndarray, spacing, dist_to_e2=None) -> float:
    """HD95 between two surface masks. Each surface voxel's distance to the
    other surface is read from a Euclidean distance transform (the distance
    of every voxel to the nearest voxel of that surface): the same nearest-
    neighbour distances as a KD-tree over the surface points, in time linear
    in the volume. `dist_to_e2` is e2's transform when the caller has it."""
    from scipy.ndimage import distance_transform_edt

    if not e1.any() or not e2.any():
        return 0.0
    if dist_to_e2 is None:
        dist_to_e2 = distance_transform_edt(~e2, sampling=spacing)
    d_2to1 = dist_to_e2[e1]
    d_1to2 = distance_transform_edt(~e1, sampling=spacing)[e2]
    out = max(np.percentile(d_1to2, 95), np.percentile(d_2to1, 95))
    if not np.isfinite(out):
        return HD95_SENTINEL
    return float(out)


def hd95(pred_mask: np.ndarray, target_mask: np.ndarray,
         spacing=(1.0, 1.0, 1.0)) -> float:
    """95th-percentile symmetric Hausdorff distance between the surfaces of
    two (D, H, W) masks (> 0.5 is inside): 0 when either surface is empty,
    HD95_SENTINEL when infinite.

    The JAX function takes nearest neighbours from a KD-tree over the
    surface points scaled by `spacing`; the distance transform here gives
    the same distances bit for bit at unit spacing (both are the square
    root of the same exact integer) and wherever the scaled coordinates
    are exact, and within a few ulps otherwise."""
    return _hd95_surfaces(_surface(np.asarray(pred_mask) > 0.5),
                          _surface(np.asarray(target_mask) > 0.5), spacing)


def hd95_regions(pred: np.ndarray, target: np.ndarray,
                 spacing=(1.0, 1.0, 1.0)) -> np.ndarray:
    """HD95 of the three nested region channels: pred (..., B, 3, D, H, W)
    (probabilities or masks) against target (B, 3, D, H, W) -> (..., 3),
    averaged over the batch. Each target surface and its distance transform
    are formed once for all the leading entries (the 15 subsets), and the
    entries run on a thread per core (scipy's convolutions and distance
    transforms release the interpreter lock); each value is computed alone,
    so the result does not depend on the scheduling."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy.ndimage import distance_transform_edt

    lead, batch = pred.shape[:-5], pred.shape[-5]
    cells = [(b, ch) for b in range(batch) for ch in range(3)]

    def target_surface(cell):
        e2 = _surface(target[cell] > 0.5)
        return e2, (distance_transform_edt(~e2, sampling=spacing) if e2.any() else None)

    def one(key):
        idx, cell = key
        e2, dist = targets[cell]
        return _hd95_surfaces(_surface(pred[idx + cell] > 0.5), e2, spacing, dist)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        targets = dict(zip(cells, pool.map(target_surface, cells)))
        values = list(pool.map(one, [(idx, cell) for idx in np.ndindex(*lead)
                                     for cell in cells]))
    return np.asarray(values).reshape(lead + (batch, 3)).mean(-2)


def hd95_region(pred: np.ndarray, target: np.ndarray, region: str = "WT",
                spacing=(1.0, 1.0, 1.0)) -> float:
    """HD95 of one nested region channel of (B, 3, D, H, W) numpy volumes
    (probabilities or masks), averaged over the batch."""
    return float(hd95_regions(pred, target, spacing)[REGION_CHANNEL[region]])
