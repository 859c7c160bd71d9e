"""The CBAM-family gates, the non-MVAE fusion module and the discriminator
block in NCDHW (counterpart of `xlstm_hved_tpu/nn/gates.py`).

The gates' two-layer MLPs are `Dense_0` and `Dense_1`, the names flax gives
the Dense layers of an `nn.Sequential` built inside the gate's compact
method; the discriminator block's conv is `Conv_0`. So a converted JAX tree
loads strictly. Convs and dense layers compute in the model's compute
dtype, InstanceNorm in at least fp32.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import BasicConv, Conv3d, Linear, channel_pool, instance_norm

# explicit padding 1 on every side, for every kernel size (the even k = 4
# of the discriminator included)
DISC_PADDING = 1


class _PooledMLP(nn.Module):
    """Dense_1(relu(Dense_0(.))) applied to the spatial mean and the spatial
    max of x, with shared weights; returns the sum of the two, (B, out)."""

    def __init__(self, channels: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = Linear(channels, hidden)
        self.Dense_1 = Linear(hidden, out)

    def pooled(self, x):
        dims = tuple(range(2, x.ndim))

        def mlp(v):
            return self.Dense_1(F.relu(self.Dense_0(v)))

        return mlp(x.mean(dim=dims)) + mlp(x.amax(dim=dims))


class ChannelGate(_PooledMLP):
    """avg+max pooled MLP channel gate: x * sigmoid(MLP(avg) + MLP(max)),
    hidden width max(channels // reduction, 2)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__(channels, max(channels // reduction, 2), channels)

    def forward(self, x):
        scale = torch.sigmoid(self.pooled(x))
        return x * scale.view(*scale.shape, *(1,) * (x.ndim - 2))


class ModalityGate(_PooledMLP):
    """One sigmoid scale per modality from the pooled MLP (hidden width
    channels // reduction): returns the list of the per-modality channel
    chunks (channels // in_modalities each), each times its scale."""

    def __init__(self, channels: int, in_modalities: int = 4, reduction: int = 4):
        super().__init__(channels, channels // reduction, in_modalities)
        self.in_modalities = in_modalities

    def forward(self, x) -> List[torch.Tensor]:
        scale = torch.sigmoid(self.pooled(x))  # (B, M)
        scale = scale.view(*scale.shape, *(1,) * (x.ndim - 2))
        chunks = x.chunk(self.in_modalities, dim=1)
        return [c * scale[:, i:i + 1] for i, c in enumerate(chunks)]


class SpatialGate(nn.Module):
    """x * sigmoid(BasicConv 7^3 to 1 channel, no LeakyReLU) of the channel
    pool of x, with `prob_channels` extra maps (`prob`) concatenated to the
    pool when given."""

    def __init__(self, prob_channels: int = 0):
        super().__init__()
        self.spatial = BasicConv(2 + prob_channels, 1, 7, relu=False)

    def forward(self, x, prob=None):
        comp = channel_pool(x)
        if prob is not None:
            comp = torch.cat([comp, prob], dim=1)
        return x * torch.sigmoid(self.spatial(comp))


class FusionModule(nn.Module):
    """The fusion arm of the non-MVAE HVED network: a gate over the
    concatenated modality features (`in_channels` in all), then a 1x1
    BasicConv `compress` to `gate_channels`. mode "modal" gates each
    modality by a ModalityGate, "ch" each channel by a ChannelGate. Returns
    (the compressed features, the list of gated features)."""

    def __init__(self, in_channels: int, gate_channels: int, mode: str = "modal",
                 in_modalities: int = 4):
        super().__init__()
        self.mode = mode
        self.gate = (ChannelGate(in_channels) if mode == "ch"
                     else ModalityGate(in_channels, in_modalities))
        self.compress = BasicConv(in_channels, gate_channels, 1)

    def forward(self, xs: Union[torch.Tensor, Sequence[torch.Tensor]]):
        x = torch.cat(list(xs), dim=1) if isinstance(xs, (list, tuple)) else xs
        if self.mode == "ch":
            gated = [self.gate(x)]
            cat = gated[0]
        else:
            gated = self.gate(x)
            cat = torch.cat(gated, dim=1)
        return self.compress(cat), gated


class DiscriminatorBlock(nn.Module):
    """conv (k, stride, padding 1, bias) -> InstanceNorm when `normalize`
    -> LeakyReLU(0.2)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 2,
                 normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        self.Conv_0 = Conv3d(cin, features, kernel, stride, padding=DISC_PADDING)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.normalize:
            x = instance_norm(x)
        return F.leaky_relu(x, negative_slope=0.2)
