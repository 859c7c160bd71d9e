"""Synthetic BraTS-like volumes, made on the device from a seed.

A frozen copy of the program's `data/synthetic.py::synthetic_subject`, with
the same formulas drawn from a `torch.Generator` on the card in place of
numpy's: smooth intensities per modality inside an ellipsoidal brain, and a
nested ellipsoidal tumour with the labels 4 (outer shell), 2, 3 and 1
(innermost), each with its own intensity offset. The model sees the
intensities over 255 and the nested masks WT (label > 0), TC (1, 2, 3) and
ET (1).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

LABEL_OFFSETS = {4: 30.0, 2: 70.0, 3: 110.0, 1: 150.0}
REGION_THRESHOLDS = ((1.0, 4), (0.75, 2), (0.55, 3), (0.4, 1))


def _uniform(gen, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def subject(gen: torch.Generator, shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(img (4, D, H, W) in [0, 255] fp32, labels (D, H, W) int8 in 0..4)."""
    dev = gen.device
    D, H, W = shape
    zz, yy, xx = torch.meshgrid(torch.linspace(-1, 1, D, device=dev),
                                torch.linspace(-1, 1, H, device=dev),
                                torch.linspace(-1, 1, W, device=dev), indexing="ij")
    center = _uniform(gen, 3, -0.25, 0.25)
    radii = _uniform(gen, 3, 0.3, 0.55)
    r = (((zz - center[0]) / radii[0]) ** 2 + ((yy - center[1]) / radii[1]) ** 2
         + ((xx - center[2]) / radii[2]) ** 2)
    brain = r < 4.0
    labels = torch.zeros(tuple(shape), dtype=torch.int8, device=dev)
    for threshold, label in REGION_THRESHOLDS:
        labels[r < threshold] = label
    noise = torch.randn((4, D, H, W), generator=gen, device=dev) * 5
    jitter = _uniform(gen, (4, len(LABEL_OFFSETS)), -5.0, 5.0)
    img = torch.empty((4, D, H, W), device=dev)
    for c in range(4):
        base = 40 + 15 * c + 15 * torch.sin(3 * (zz + c)) * torch.cos(2 * yy)
        boost = torch.zeros_like(base)
        for i, (label, offset) in enumerate(LABEL_OFFSETS.items()):
            boost[labels == label] = offset + jitter[c, i]
        img[c] = torch.clamp((base + noise[c] + boost) * brain, 0, 255)
    return img, labels


def nested_masks(labels: torch.Tensor) -> torch.Tensor:
    """(D, H, W) labels -> (3, D, H, W) fp32 WT, TC, ET."""
    wt = labels > 0
    tc = (labels == 1) | (labels == 2) | (labels == 3)
    return torch.stack([wt, tc, labels == 1]).float()


def pool(gen: torch.Generator, n: int, shape: Sequence[int]):
    """n subjects as model inputs: x (n, 4, *shape) in [0, 1] and the
    nested masks (n, 3, *shape)."""
    xs, masks = [], []
    for _ in range(n):
        img, labels = subject(gen, shape)
        xs.append(img / 255.0)
        masks.append(nested_masks(labels))
    return torch.stack(xs), torch.stack(masks)
