"""Sliding-window whole-volume inference and the 15-subset sweep
(counterpart of the plain sweep in `xlstm_hved_tpu/engine/evaluate.py`).

Windows tile the volume on a static origin grid whose last window along each
axis ends at the border; overlapping predictions are averaged. Dropped
modalities are zeroed in the input and the model also receives the keep
mask. Volumes are (B, M, D, H, W); the sweep returns seg (15, B, C, D, H, W)
and, with recon channels, recon (15, B, R, D, H, W). The hoisted and sharded
sweeps of the JAX engine come in a later slice.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from xlstm_hved_torch.utils.subsets import SUBSET_MASKS


def window_origins(dim: int, patch: int, stride: int) -> Tuple[int, ...]:
    """Start offsets covering [0, dim), with a last window ending at dim."""
    if dim <= patch:
        return (0,)
    starts = list(range(0, dim - patch + 1, stride))
    if starts[-1] != dim - patch:
        starts.append(dim - patch)
    return tuple(starts)


def origin_grid(shape: Sequence[int], patch: Sequence[int],
                stride: Sequence[int]) -> np.ndarray:
    """(N, 3) int32 window origins, D-major."""
    ds = window_origins(shape[0], patch[0], stride[0])
    hs = window_origins(shape[1], patch[1], stride[1])
    ws = window_origins(shape[2], patch[2], stride[2])
    return np.asarray([(d, h, w) for d in ds for h in hs for w in ws], dtype=np.int32)


def make_sliding_window(apply_fn: Callable, patch: Sequence[int],
                        stride: Optional[Sequence[int]] = None,
                        out_channels: int = 3, recon_channels: int = 0):
    """Build predict(model, x, keep) -> (seg, recon | None), averaged over
    overlapping windows.

    apply_fn(model, x_patch, keep) returns (seg (B, out_channels, *patch),
    recon (B, recon_channels, *patch) or None).
    """
    patch = tuple(patch)
    stride = tuple(stride) if stride is not None else patch

    @torch.no_grad()
    def predict(model, x, keep):
        B, M = x.shape[:2]
        vol = tuple(x.shape[2:])
        keep = torch.as_tensor(keep, device=x.device).bool()
        x = x * keep.reshape(1, M, 1, 1, 1).to(x.dtype)
        seg_sum = x.new_zeros((B, out_channels, *vol), dtype=torch.float32)
        rec_sum = (x.new_zeros((B, recon_channels, *vol), dtype=torch.float32)
                   if recon_channels else None)
        count = x.new_zeros((1, 1, *vol), dtype=torch.float32)
        for d, h, w in origin_grid(vol, patch, stride).tolist():
            win = (slice(None), slice(None), slice(d, d + patch[0]),
                   slice(h, h + patch[1]), slice(w, w + patch[2]))
            seg_p, rec_p = apply_fn(model, x[win], keep)
            seg_sum[win] += seg_p.float()
            if rec_sum is not None:
                rec_sum[win] += rec_p.float()
            count[win] += 1.0
        return seg_sum / count, (rec_sum / count if rec_sum is not None else None)

    return predict


def make_subset_sweep(apply_fn: Callable, patch: Sequence[int],
                      stride: Optional[Sequence[int]] = None,
                      out_channels: int = 3, recon_channels: int = 0):
    """sweep(model, x) runs the sliding window once per modality subset, in
    the order of SUBSET_MASKS, and returns seg (15, B, out_channels, ...)
    and, when recon_channels > 0, recon (15, B, recon_channels, ...)."""
    predict = make_sliding_window(apply_fn, patch, stride, out_channels,
                                  recon_channels)

    def sweep(model, x):
        segs, recs = [], []
        for keep in SUBSET_MASKS:
            seg, rec = predict(model, x, torch.tensor(keep))
            segs.append(seg)
            recs.append(rec)
        if not recon_channels:
            return torch.stack(segs)
        return torch.stack(segs), torch.stack(recs)

    return sweep


def default_apply_fn(model, *, recon: bool = False):
    """Eval-mode apply with deterministic latents. `model` is taken for the
    JAX engine's signature; the network called is the one the window passes."""
    del model

    def apply_fn(net, x_patch, keep):
        out = net(x_patch, keep=keep, recon=recon, deterministic=True)
        return out.seg, out.recon

    return apply_fn


def label_volume_from_probs(seg: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Nested WT/TC/ET probabilities (..., 3, D, H, W) -> BraTS labels
    (..., D, H, W) with WT->2, TC->1, ET->4."""
    wt, tc, et = (seg[..., c, :, :, :] > threshold for c in range(3))
    out = np.zeros(wt.shape, dtype=np.uint8)
    out[wt] = 2
    out[wt & tc] = 1
    out[wt & tc & et] = 4
    return out
