"""Carry the JAX package's weights into the port.

The port names its submodules after the flax scopes, so a flax leaf
`a/b/kernel` becomes the torch key `a.b.weight` and only its layout changes
(the HVED network's tree, and the Discriminator's `block{i}/Conv_0/kernel|bias`
and `last/kernel` alike):

- 3D conv kernel (k, k, k, Cin, Cout)           -> (Cout, Cin, k, k, k)
- 2D conv kernel (kh, kw, Cin, Cout)            -> (Cout, Cin, kh, kw) (the 2-D
  UxLSTM nets, VisionLSTM's patch embedding)
- block-diagonal conv kernel (M, k, k, k, cin, cout) -> (M*cout, cin, k, k, k),
  the weight of the grouped conv (stream m owns outputs [m*cout, (m+1)*cout));
  its bias (M, cout) is flattened the same way (the HVED folded encoders,
  and U-HeMIS's four `nn.vmap`ped encoder streams)
- CausalConv1d kernel (k, 1, C)                 -> (C, 1, k)
- Dense kernel (in, out)                        -> Linear weight (out, in)
  (DuSE's fc_*, the gates' Dense_0 / Dense_1)
- BatchNorm scale / bias / mean / var           -> weight / bias /
  running_mean / running_var (plus num_batches_tracked = 0)
- GroupNorm scale / bias                        -> weight / bias
- PReLU alpha ()                                -> weight (1,)
- every other leaf (LinearHeadwiseExpand weight (NH, out_d, in_d), norm
  weights, learnable_skip, 1D biases, the Vision-LSTM position embeddings
  `embed` (1, *grid, dim) and `pos_embed` (1, S, dim)) is kept as it is.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def _param(path: tuple, leaf: np.ndarray):
    *scope, name = path
    if name == "kernel":
        if leaf.ndim == 6:
            m, kd, kh, kw, cin, cout = leaf.shape
            leaf = leaf.transpose(0, 5, 4, 1, 2, 3).reshape(m * cout, cin, kd, kh, kw)
        elif leaf.ndim == 5:
            leaf = leaf.transpose(4, 3, 0, 1, 2)
        elif leaf.ndim == 4:
            leaf = leaf.transpose(3, 2, 0, 1)
        elif leaf.ndim == 3:
            leaf = leaf.transpose(2, 1, 0)
        elif leaf.ndim == 2:
            leaf = leaf.T
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {leaf.shape}")
        name = "weight"
    elif name == "bias":
        leaf = leaf.reshape(-1)
    elif name == "scale":
        name = "weight"
    elif name == "alpha":
        leaf, name = leaf.reshape(1), "weight"
    return ".".join((*scope, name)), leaf


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def params_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax `params` (and `batch_stats`), nested dicts of arrays, -> the
    port model's state_dict for `load_state_dict(strict=True)`."""
    state = {}
    for path, leaf in _flatten(params).items():
        key, value = _param(path, leaf)
        state[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    for path, leaf in _flatten(batch_stats or {}).items():
        *scope, name = path
        state[".".join((*scope, _STAT_NAMES[name]))] = torch.from_numpy(
            np.ascontiguousarray(leaf, dtype=np.float32))
        if name == "mean":
            state[".".join((*scope, "num_batches_tracked"))] = torch.tensor(0)
    return state
