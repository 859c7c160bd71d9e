"""The U-HeMIS baseline (counterpart of `xlstm_hved_tpu/models/hemis.py`):
four per-modality conv encoder streams, a per-level mean and variance over
the modality streams, four recon decoders and one seg decoder.

The JAX model runs its four encoders under `nn.vmap` (each leaf has a
leading axis of 4); here they are one stack of grouped convs on the folded
layout, stream m owning channels [m*C, (m+1)*C) of every map, which is how
`utils/convert.py` reads a 6-D vmapped kernel. The (B, 4, D, H, W) input is
that layout already, one channel per stream. A dropped modality is a zero
keep-mask factor on every skip; the mean and the (unbiased) variance run
over all four streams, the dropped ones contributing zeros, as the
published U-HeMIS does. Channels-first throughout; names follow the flax
scopes, so a converted JAX tree loads with `load_state_dict(strict=True)`.
No kernel of this repository runs here: convs, norms and resizes are
PyTorch's. `dtype` is the convs' compute dtype (cast at the op).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import (BasicConv, SingleConv, max_pool3d, resize_trilinear,
                                        set_compute_dtype)


class HemisBlock(nn.Module):
    """Two SingleConvs (not residual); the encoder's narrows conv2 to
    features // 2. With `streams` > 1 it is that many independent blocks on
    the folded layout (cin and features per stream)."""

    def __init__(self, cin: int, features: int, encoder: bool = False, order: str = "ilc",
                 streams: int = 1):
        super().__init__()
        c1, c2 = (features, features // 2) if encoder else (features, features)
        self.conv1 = SingleConv(streams * cin, streams * c1, order, streams=streams)
        self.conv2 = SingleConv(streams * c1, streams * c2, order, streams=streams)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class HemisEncoder(nn.Module):
    """`streams` per-modality encoders on the folded layout: a 1x1 conv and
    LeakyReLU ("init"), then four blocks with 2x max pooling between them.
    Returns the four skips, (B, streams * C, ...) with C = n/2, n, 2n, 4n
    per stream."""

    def __init__(self, n_base: int = 8, order: str = "ilc", streams: int = 4):
        super().__init__()
        n = n_base
        self.init = BasicConv(streams, streams * n, 1, groups=streams, relu=True, norm=False)
        cin = n
        for i, feat in enumerate((n, 2 * n, 4 * n, 8 * n)):
            self.add_module(f"block{i}", HemisBlock(cin, feat, True, order, streams))
            cin = feat // 2

    def forward(self, x) -> List[torch.Tensor]:
        x = self.init(x)
        skips = []
        for i in range(4):
            x = getattr(self, f"block{i}")(x)
            skips.append(x)
            x = max_pool3d(x)
        return skips


def hemis_abstraction(stack: torch.Tensor) -> torch.Tensor:
    """concat(mean, var) over the modality axis 1 of (B, M, C, ...) ->
    (B, 2C, ...); the variance unbiased (ddof 1), as torch.var and the
    published model take it."""
    return torch.cat([stack.mean(dim=1), stack.var(dim=1, unbiased=True)], dim=1)


class HemisDecoder(nn.Module):
    """Three stages of trilinear upsampling to the next skip, concatenation
    and a HemisBlock (4n, 2n, n), then a bias-free 1x1 conv ("final") to
    `num_cls` channels. `skip_ch` are the fused skips' widths."""

    def __init__(self, num_cls: int, n_base: int = 8, order: str = "ilc",
                 skip_ch: Sequence[int] = ()):
        super().__init__()
        n = n_base
        skip_ch = tuple(skip_ch) or (n, 2 * n, 4 * n, 8 * n)
        cin = skip_ch[3]
        for j, feat in enumerate((4 * n, 2 * n, n)):
            self.add_module(f"dec{j}", HemisBlock(cin + skip_ch[2 - j], feat, False, order))
            cin = feat
        self.final = BasicConv(n, num_cls, 1, relu=False, norm=False)

    def forward(self, skips: Sequence[torch.Tensor]):
        x = skips[3]
        for j in range(3):
            skip = skips[2 - j]
            x = resize_trilinear(x, skip.shape[2:])
            x = getattr(self, f"dec{j}")(torch.cat([x, skip], dim=1))
        return self.final(x)


class UHeMIS(nn.Module):
    """U-HeMIS: (B, modalities, D, H, W) -> (seg (B, num_cls, ...), recon
    (B, modalities, ...)); seg is a softmax over classes, or a sigmoid with
    `final_sigmoid`. `keep` (B, M) or (M,) says which modalities are
    present; None infers it from the channels that are not all zero."""

    def __init__(self, num_cls: int = 3, n_base: int = 8, final_sigmoid: bool = False,
                 dtype: Optional[torch.dtype] = None, modalities: int = 4):
        super().__init__()
        self.final_sigmoid, self.modalities = final_sigmoid, modalities
        n = n_base
        self.encoders = HemisEncoder(n, streams=modalities)
        for i in range(modalities):
            self.add_module(f"recon_decoder_{i}", HemisDecoder(1, n))
        self.seg_decoder = HemisDecoder(num_cls, n)
        set_compute_dtype(self, dtype)

    def forward(self, x, keep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, M = x.shape[:2]
        if M != self.modalities:
            raise ValueError(f"UHeMIS expects {self.modalities} modalities, got {M}")
        if keep is None:
            keep = x.abs().sum(dim=(2, 3, 4)) != 0
        keep = torch.as_tensor(keep, device=x.device).to(x.dtype)
        if keep.dim() == 1:
            keep = keep[None].expand(B, M)
        fused = []
        for s in self.encoders(x):
            stack = s.reshape(B, M, -1, *s.shape[2:])
            fused.append(hemis_abstraction(stack * keep.to(s.dtype)[:, :, None, None, None, None]))
        recon = torch.cat([getattr(self, f"recon_decoder_{i}")(fused) for i in range(M)], dim=1)
        seg = self.seg_decoder(fused)
        seg = torch.sigmoid(seg) if self.final_sigmoid else F.softmax(seg, dim=1)
        return seg, recon
