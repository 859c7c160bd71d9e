"""Signed distance maps for the boundary loss (host side, scipy EDT; the
port's own copy of `xlstm_hved_tpu/data/sdm.py`).

Per-channel normalised SDF in [-1, 1], zero on the boundary, negative
inside the mask. An inner boundary voxel is one that is foreground with at
least one background 6-neighbour. The port's masks are NCDHW, so
`compute_sdm` takes and returns (B, C, D, H, W), where the JAX function is
channels-last.
"""
from __future__ import annotations

import numpy as np


def _inner_boundary(mask: np.ndarray) -> np.ndarray:
    """Foreground voxels adjacent (6-connectivity) to background."""
    pad = np.pad(mask, 1, mode="constant")
    core = pad[1:-1, 1:-1, 1:-1]
    neighbor_bg = np.zeros_like(mask, dtype=bool)
    for axis in range(3):
        for shift in (-1, 1):
            rolled = np.roll(pad, shift, axis=axis)[1:-1, 1:-1, 1:-1]
            neighbor_bg |= ~rolled
    return core & neighbor_bg


def compute_per_channel_sdm(seg: np.ndarray) -> np.ndarray:
    """seg: (B, D, H, W) binary. Returns the normalised SDF per batch
    element."""
    from scipy.ndimage import distance_transform_edt as edt

    seg = seg.astype(bool)
    out = np.zeros(seg.shape, np.float32)
    for b in range(seg.shape[0]):
        pos = seg[b]
        if not pos.any():
            continue
        neg = ~pos
        posdis = edt(pos)
        negdis = edt(neg)
        pos_rng = max(posdis.max() - posdis.min(), 1e-8)
        neg_rng = max(negdis.max() - negdis.min(), 1e-8)
        sdf = (negdis - negdis.min()) / neg_rng - (posdis - posdis.min()) / pos_rng
        sdf[_inner_boundary(pos)] = 0.0
        out[b] = sdf
    return out


def compute_sdm(seg: np.ndarray) -> np.ndarray:
    """seg: (B, C, D, H, W) binary masks -> (B, C, D, H, W) SDMs."""
    out = np.zeros(seg.shape, np.float32)
    for c in range(seg.shape[1]):
        out[:, c] = compute_per_channel_sdm(seg[:, c])
    return out
