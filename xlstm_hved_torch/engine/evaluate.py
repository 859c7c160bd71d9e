"""Sliding-window whole-volume inference and the 15-subset sweep
(counterpart of `xlstm_hved_tpu/engine/evaluate.py`).

Windows tile the volume on a static origin grid whose last window along each
axis ends at the border; overlapping predictions are averaged. Dropped
modalities are zeroed in the input and the model also receives the keep
mask. Volumes are (B, M, D, H, W); the sweeps return seg (15, B, C, D, H, W)
and, with recon channels, recon (15, B, R, D, H, W), subsets in the order of
SUBSET_MASKS.

- `make_subset_sweep`: the sliding window once per subset, or `subset_chunk`
  subsets at a time as one batch of per-instance keep-masks.
- `make_hoisted_subset_sweep`: per window, the model's subset-invariant
  prefix once on the full input, then 15 suffixes (`models/hved.py`); it
  equals the plain sweep.
- `make_sharded_subset_sweep`: the hoisted sweep with the subsets split
  over the ranks of a mesh's data axis, gathered back in order.
The windows accumulate in fp32 whatever the model's compute dtype.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from xlstm_hved_torch.parallel.mesh import all_gather
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
    recon (B, recon_channels, *patch) or None). keep is (4,) or (B, 4).
    """
    patch = tuple(patch)
    stride = tuple(stride) if stride is not None else patch

    @torch.no_grad()
    def predict(model, x, keep):
        B, M = x.shape[:2]
        vol = tuple(x.shape[2:])
        keep = torch.as_tensor(keep, device=x.device).bool()
        x = x * keep.reshape(-1, M, 1, 1, 1).to(x.dtype)
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
                      out_channels: int = 3, recon_channels: int = 0,
                      subset_chunk: int = 1):
    """sweep(model, x) runs the sliding window over the modality subsets, in
    the order of SUBSET_MASKS, and returns seg (15, B, out_channels, ...)
    and, when recon_channels > 0, recon (15, B, recon_channels, ...).

    `subset_chunk` subsets run at a time, as one batch of chunk * B rows
    with a keep-mask per row; the subset table is padded to a multiple of
    the chunk with repeats of its last row, whose outputs are dropped."""
    predict = make_sliding_window(apply_fn, patch, stride, out_channels,
                                  recon_channels)
    n_subsets = len(SUBSET_MASKS)
    if not 1 <= subset_chunk <= n_subsets:
        raise ValueError(f"subset_chunk must be in [1, {n_subsets}], got {subset_chunk}")
    n_pad = (-n_subsets) % subset_chunk
    table = np.concatenate([SUBSET_MASKS, np.repeat(SUBSET_MASKS[-1:], n_pad, axis=0)])

    def sweep(model, x):
        B = x.shape[0]
        segs, recs = [], []
        for c in range(0, len(table), subset_chunk):
            keep = torch.from_numpy(table[c:c + subset_chunk]).to(x.device)
            if subset_chunk > 1:  # row i is subset c + i // B of batch item i % B
                seg, rec = predict(model, x.repeat(subset_chunk, 1, 1, 1, 1),
                                   keep.repeat_interleave(B, dim=0))
            else:
                seg, rec = predict(model, x, keep[0])
            segs.append(seg.reshape(-1, B, *seg.shape[1:]))
            if rec is not None:
                recs.append(rec.reshape(-1, B, *rec.shape[1:]))
        if not recon_channels:
            return torch.cat(segs)[:n_subsets]
        return torch.cat(segs)[:n_subsets], torch.cat(recs)[:n_subsets]

    return sweep


def _hoisted_sweep_body(patch: Sequence[int], stride: Optional[Sequence[int]],
                        out_channels: int, recon_channels: int):
    """body(net, x, masks) -> seg (S, B, out_channels, ...) and, with recon
    channels, recon: the hoisted sweep over the (S, 4) keep-masks `masks`."""
    patch = tuple(patch)
    stride = tuple(stride) if stride is not None else patch
    recon = recon_channels > 0

    @torch.no_grad()
    def body(net, x, masks):
        n = masks.shape[0]
        B, M = x.shape[:2]
        vol = tuple(x.shape[2:])
        masks = masks.to(x.device)
        seg_sum = x.new_zeros((n, B, out_channels, *vol), dtype=torch.float32)
        rec_sum = (x.new_zeros((n, B, recon_channels, *vol), dtype=torch.float32)
                   if recon else None)
        count = x.new_zeros((1, 1, *vol), dtype=torch.float32)
        for d, h, w in origin_grid(vol, patch, stride).tolist():
            win = (slice(None), slice(None), slice(d, d + patch[0]),
                   slice(h, h + patch[1]), slice(w, w + patch[2]))
            crop = x[win]
            pref = net(crop, mode="prefix", deterministic=True)
            for s in range(n):
                crop_m = crop * masks[s].reshape(1, M, 1, 1, 1).to(crop.dtype)
                out = net(crop_m, keep=masks[s], mode="suffix", prefix=pref,
                          recon=recon, deterministic=True)
                seg_sum[s][win] += out.seg.float()
                if recon:
                    rec_sum[s][win] += out.recon.float()
            del pref
            count[win] += 1.0
        if not recon:
            return seg_sum / count
        return seg_sum / count, rec_sum / count

    return body


def make_hoisted_subset_sweep(model, patch: Sequence[int],
                              stride: Optional[Sequence[int]] = None,
                              out_channels: int = 3, recon_channels: int = 0):
    """The 15-subset sweep with the subset-invariant forward prefix hoisted
    out of the subset loop: per window, one `mode="prefix"` pass on the full
    window, then one `mode="suffix"` pass per subset on the masked window,
    accumulated as `make_sliding_window` accumulates. `model` is an
    HVEDFusionNet; deterministic latents, no gradient.

    Returns sweep(model, x) -> seg (15, B, out_channels, ...) and, when
    recon_channels > 0, recon (15, B, recon_channels, ...)."""
    del model  # the JAX engine's signature; the network is sweep's argument
    body = _hoisted_sweep_body(patch, stride, out_channels, recon_channels)
    keeps = torch.tensor(SUBSET_MASKS)
    return lambda net, x: body(net, x, keeps)


def make_sharded_subset_sweep(model, mesh, patch: Sequence[int],
                              stride: Optional[Sequence[int]] = None,
                              out_channels: int = 3, recon_channels: int = 0):
    """The hoisted 15-subset sweep with the subsets split over the mesh's
    data axis: the subset table is padded to a multiple of the axis's size
    with repeats of the full subset, each rank runs the hoisted body on its
    block of keep-masks (every rank computes the window's prefix), and the
    blocks are gathered on the subset axis in rank order, the padding
    dropped. Every rank returns the whole result, equal to
    `make_hoisted_subset_sweep`'s."""
    del model
    n_subsets = len(SUBSET_MASKS)
    n_pad = (-n_subsets) % mesh.data
    table = torch.from_numpy(np.concatenate(
        [SUBSET_MASKS, np.repeat(SUBSET_MASKS[-1:], n_pad, axis=0)]))
    per_rank = len(table) // mesh.data
    mine = table[mesh.data_rank * per_rank:(mesh.data_rank + 1) * per_rank]
    body = _hoisted_sweep_body(patch, stride, out_channels, recon_channels)
    recon = recon_channels > 0

    def gather(t):
        if mesh.data == 1:
            return t
        return all_gather(t, mesh.data_group).flatten(0, 1)[:n_subsets]

    @torch.no_grad()
    def sweep(net, x):
        out = body(net, x, mine)
        if recon:
            return gather(out[0]), gather(out[1])
        return gather(out)

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
