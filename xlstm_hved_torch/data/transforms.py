"""Augmentation pipeline (the port's own copy of
`xlstm_hved_tpu/data/transforms.py`).

The training pipeline (intensity shift 0.1, flip probability 0.5, random
crop, /255, SegToMask) comes in two equivalent forms:
- `host_augment` (numpy), the batch assembly's default: augmenting before
  the host-to-device copy ships only the crop. It and the other host
  functions are the JAX package's, line for line, so the same
  `RandomState` gives the same arrays;
- `device_augment`, the same pipeline in torch on the tensor's device,
  drawing from an explicit `torch.Generator` (the same distributions as the
  JAX function, not the same draws).
Device functions take an item as the datasets give it, channels-last
(D, H, W, C) with labels (D, H, W), and return it channels-first, (C, d, h,
w) and a (3, d, h, w) mask, ready to stack into an NCDHW batch.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# /255 as the JAX device functions compute it: XLA turns the division by a
# constant into a product with its fp32 reciprocal (the host functions
# divide, which differs in the last bit)
_INV_255 = 1.0 / 255.0

# ---------------- on-device (torch) pipeline ----------------


def seg_to_mask(labels: torch.Tensor) -> torch.Tensor:
    """BraTS labels (..., D, H, W) -> (..., 3, D, H, W) fp32 nested channels
    WT = (m > 0), TC = (m in 1, 2, 3), ET = (m == 1)."""
    wt = labels > 0
    tc = (labels == 1) | (labels == 2) | (labels == 3)
    et = labels == 1
    return torch.stack([wt, tc, et], dim=-4).float()


def _uniform(generator: torch.Generator, shape, low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (high - low) * u


def intensity_shift(generator: torch.Generator, img: torch.Tensor,
                    scale: float = 0.1) -> torch.Tensor:
    """x + std(nonzero voxels) * alpha on the nonzero voxels, per channel,
    one alpha ~ U(-scale, scale) per sample. img: (D, H, W, C)."""
    alpha = _uniform(generator, (), -scale, scale).to(img.device)
    nz = (img != 0).float()
    cnt = torch.clamp(nz.sum(dim=(0, 1, 2)), min=1.0)
    mean = (img * nz).sum(dim=(0, 1, 2)) / cnt
    var = ((img - mean).square() * nz).sum(dim=(0, 1, 2)) / cnt
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(img != 0, img + std * alpha, torch.zeros_like(img))


def intensity_scale(generator: torch.Generator, img: torch.Tensor,
                    scale: float = 0.1) -> torch.Tensor:
    return img * _uniform(generator, (), 1.0 - scale, 1.0 + scale).to(img.device)


def random_flip(generator: torch.Generator, img: torch.Tensor, labels: torch.Tensor,
                prob: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip each spatial axis when its draw U(0, 1) exceeds `prob` (the
    upstream rule: probability 1 - prob). img (D, H, W, C), labels (D, H, W)."""
    flips = (_uniform(generator, (3,)) > prob).tolist()
    axes = [a for a in range(3) if flips[a]]
    if axes:
        img, labels = torch.flip(img, axes), torch.flip(labels, axes)
    return img, labels


def random_crop(generator: torch.Generator, img: torch.Tensor, labels: torch.Tensor,
                crop: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform-origin crop of the spatial axes to `crop`."""
    u = _uniform(generator, (3,)).tolist()
    origin = [min(int(u[a] * (img.shape[a] - crop[a] + 1)), img.shape[a] - crop[a])
              for a in range(3)]
    sl = tuple(slice(o, o + c) for o, c in zip(origin, crop))
    return img[sl], labels[sl]


def device_augment(generator: torch.Generator, img: torch.Tensor, labels: torch.Tensor,
                   crop: Tuple[int, int, int], shift: float = 0.1,
                   flip_prob: float = 0.5, normalize: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-time pipeline on img's device: shift -> flip -> crop -> /255 ->
    SegToMask. img: (D, H, W, 4) raw intensities; labels: (D, H, W).
    Returns ((4, *crop) fp32, (3, *crop) fp32 mask)."""
    if shift:
        img = intensity_shift(generator, img, shift)
    if flip_prob:
        img, labels = random_flip(generator, img, labels, flip_prob)
    img, labels = random_crop(generator, img, labels, crop)
    if normalize:
        img = img * _INV_255
    return img.permute(3, 0, 1, 2).contiguous(), seg_to_mask(labels)


def device_eval_transform(img: torch.Tensor, labels: torch.Tensor,
                          crop: Optional[Tuple[int, int, int]] = None,
                          normalize: bool = True):
    """Eval pipeline on img's device: centre crop + /255 + SegToMask.
    img: (D, H, W, C); labels: (D, H, W). Returns ((C, *crop), (3, *crop))."""
    if crop is not None:
        origin = [(img.shape[a] - crop[a]) // 2 for a in range(3)]
        sl = tuple(slice(o, o + c) for o, c in zip(origin, crop))
        img, labels = img[sl], labels[sl]
    img = img.float()
    if normalize:
        img = img * _INV_255
    return img.permute(3, 0, 1, 2).contiguous(), seg_to_mask(labels)


# ---------------- host (numpy) pipeline, as in the JAX package ----------------

def host_seg_to_mask(m: np.ndarray) -> np.ndarray:
    wt = (m > 0).astype(np.uint8)
    tc = ((m == 1) | (m == 2) | (m == 3)).astype(np.uint8)
    et = (m == 1).astype(np.uint8)
    return np.stack([wt, tc, et], axis=-1)


def host_zscore_nonzero(img: np.ndarray) -> np.ndarray:
    """Per-channel z-score over non-background voxels (the HDF5 loaders'
    normalisation). img: (C, D, H, W)."""
    out = np.zeros_like(img, dtype=np.float32)
    for c in range(img.shape[0]):
        ch = img[c]
        mask = ch != 0
        if mask.any():
            mu, sd = ch[mask].mean(), ch[mask].std()
            out[c] = np.where(mask, (ch - mu) / max(sd, 1e-8), 0.0)
    return out


def host_augment(rng: np.random.RandomState, img: np.ndarray,
                 labels: np.ndarray, crop: Sequence[int],
                 shift: float = 0.1, flip_prob: float = 0.5,
                 normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy form of `device_augment` (shift -> flip -> crop -> /255 ->
    SegToMask), for host-side batch assembly: augmenting before the
    host-to-device copy ships only the crop. img: (D, H, W, C) raw
    intensities; labels: (D, H, W). Returns (crop fp32 (*crop, C), mask
    uint8 (*crop, 3))."""
    if shift:
        alpha = rng.uniform(-shift, shift)
        nz = img != 0
        out = np.zeros_like(img, dtype=np.float32)
        for c in range(img.shape[-1]):
            ch, m = img[..., c], nz[..., c]
            if m.any():
                out[..., c] = np.where(m, ch + ch[m].std() * alpha, 0.0)
        img = out
    else:
        img = img.astype(np.float32)
    if flip_prob:
        for axis in range(3):
            if rng.uniform() > flip_prob:
                img = np.flip(img, axis=axis)
                labels = np.flip(labels, axis=axis)
    origin = [int(rng.uniform() * (img.shape[a] - crop[a] + 1))
              for a in range(3)]
    origin = [min(o, img.shape[a] - crop[a]) for a, o in enumerate(origin)]
    sl = tuple(slice(o, o + c) for o, c in zip(origin, crop))
    img = np.ascontiguousarray(img[sl])
    labels = np.ascontiguousarray(labels[sl])
    if normalize:
        img = img / np.float32(255.0)
    return img.astype(np.float32), host_seg_to_mask(labels)


def host_eval_transform(img: np.ndarray, labels: np.ndarray,
                        crop: Optional[Sequence[int]] = None,
                        normalize: bool = True):
    """Numpy form of `device_eval_transform`: deterministic centre crop +
    /255 + SegToMask, channels-last, before the host-to-device copy."""
    if crop is not None:
        origin = tuple((img.shape[a] - crop[a]) // 2 for a in range(3))
        sl = tuple(slice(o, o + c) for o, c in zip(origin, crop))
        img = img[sl]
        labels = labels[sl]
    img = img.astype(np.float32)
    if normalize:
        img = img / np.float32(255.0)
    return np.ascontiguousarray(img), host_seg_to_mask(labels)


def host_add_gaussian_noise(rng: np.random.RandomState, img: np.ndarray,
                            mean: float = 0.0, std: float = 0.01
                            ) -> np.ndarray:
    """Additive Gaussian noise (upstream AddGaussianNoise)."""
    return img + rng.randn(*img.shape) * std + mean


def host_random_rotate90(rng: np.random.RandomState, img: np.ndarray,
                         mask: np.ndarray):
    """k * 90-degree rotation about the z axis, axes (1, 2) of DHW
    (upstream RandomRotate90). img: (C, D, H, W)."""
    k = rng.randint(0, 4)
    mask = np.rot90(mask, k, (1, 2))
    img = np.stack([np.rot90(img[c], k, (1, 2))
                    for c in range(img.shape[0])], axis=0)
    return img, mask


def host_random_scale(rng: np.random.RandomState, img: np.ndarray,
                      mask: np.ndarray, scale: float = 0.1):
    """Random zoom back to the original size (upstream Scale): factor ~
    U(1 - scale, 1 + scale); mask zoomed order 0, each image channel order 2
    with the channel's corner voxel as cval; centre-pad (factor < 1, the
    image pads with the corner value) or centre-crop (factor > 1).
    img: (C, D, H, W); mask: (D, H, W)."""
    from scipy.ndimage import zoom

    size = img[0].shape
    factor = rng.uniform(low=1.0 - scale, high=1.0 + scale)

    def fit(vol, cval):
        if factor < 1.0:
            pads = []
            for a in range(3):
                d = (size[a] - vol.shape[a]) / 2.0
                pads.append((int(np.floor(d)), int(np.ceil(d))))
            return np.pad(vol, pads, mode="constant", constant_values=cval)
        lo = [(vol.shape[a] - size[a]) // 2 for a in range(3)]
        return vol[lo[0]:lo[0] + size[0], lo[1]:lo[1] + size[1],
                   lo[2]:lo[2] + size[2]]

    out_mask = fit(zoom(mask, factor, order=0, mode="constant", cval=0), 0)
    out_img = np.zeros_like(img)
    for c in range(img.shape[0]):
        cval = img[c, 0, 0, 0]
        out_img[c] = fit(zoom(img[c], factor, order=2, mode="constant",
                              cval=cval), cval)
    return out_img, out_mask


def host_zscore_ref(img: np.ndarray) -> np.ndarray:
    """The upstream HDF5 sets' `normalize`: one voxel mask taken from
    channel 0 (not per channel), per-channel mean/std over that mask,
    applied to all voxels including the background. img: (C, D, H, W)."""
    chlast = np.moveaxis(img, 0, -1).astype(np.float32)   # (D,H,W,C)
    sel = chlast[chlast[..., 0] != 0]                     # (N, C)
    mu = sel.mean(axis=0)
    sd = sel.std(axis=0) + 1e-6
    return np.moveaxis((chlast - mu) / sd, -1, 0)


def extract_brain(img: np.ndarray, mask: np.ndarray, patch_size: int = 112
                  ) -> tuple:
    """Dynamic brain-bounding-box crop with the upstream semantics:
    background is the corner voxel of channel 0; the bbox of
    `img[0] != background` is taken per axis (max exclusive); an axis whose
    extent is below `patch_size` is widened to it, pad // 2 on the min side
    and the rest on the max side, with min clamped at 0 and the overflow
    pushed onto max (numpy slicing then clamps max at the array bound).
    img: (C, D, H, W); mask: (D, H, W)."""
    background = img[0, 0, 0, 0]
    brain = np.where(img[0] != background)
    lo = [int(np.min(b)) for b in brain]
    hi = [int(np.max(b)) + 1 for b in brain]
    for a in range(3):
        if hi[a] - lo[a] < patch_size:
            pad = patch_size - (hi[a] - lo[a])
            min_pad = pad // 2
            max_pad = pad - min_pad
            lo[a] -= min_pad
            if lo[a] < 0:
                max_pad -= lo[a]
                lo[a] = 0
            hi[a] += max_pad
    sl = tuple(slice(l, h) for l, h in zip(lo, hi))
    return img[(slice(None),) + sl], mask[sl]


def host_random_rotate(rng: np.random.RandomState, img: np.ndarray,
                       labels: np.ndarray, angle_spectrum: int = 30,
                       axes=((2, 1),)):
    """scipy-based RandomRotate (upstream); host only."""
    from scipy.ndimage import rotate

    axis = axes[rng.randint(len(axes))]
    angle = rng.randint(-angle_spectrum, angle_spectrum)
    labels = rotate(labels, angle, axes=axis, reshape=False, order=0,
                    mode="reflect", cval=0)
    chans = [rotate(img[c], angle, axes=axis, reshape=False, order=0,
                    mode="reflect", cval=float(img[c, 0, 0, 0]))
             for c in range(img.shape[0])]
    return np.stack(chans, axis=0), labels


def background_info(img: np.ndarray, patch_size: Optional[Sequence[int]] = None
                    ) -> np.ndarray:
    """Brain bounding-box min corner, padded so the box holds at least
    patch_size per axis (upstream background_info). img: (C, D, H, W)."""
    brain = np.any(img != 0, axis=0)
    if not brain.any():
        return np.zeros(3, np.int32)
    idx = np.argwhere(brain)
    lo = idx.min(axis=0)
    hi = idx.max(axis=0) + 1
    if patch_size is not None:
        for a in range(3):
            need = patch_size[a] - (hi[a] - lo[a])
            if need > 0:
                lo[a] = max(0, lo[a] - need // 2)
                hi[a] = min(brain.shape[a], lo[a] + patch_size[a])
                lo[a] = max(0, hi[a] - patch_size[a])
    return lo.astype(np.int32)
