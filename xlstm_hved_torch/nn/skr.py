"""Skip-return gate blocks in NCDHW (counterpart of the skip-return subset of
`xlstm_hved_tpu/nn/skr.py`).

BatchNorm (`nn.blocks.BatchNorm3d`, eps 1e-5) follows the module's mode:
running statistics in eval mode, loaded from the flax `batch_stats` by
`utils/convert.py`; batch statistics with flax's running-stat update in
training mode. The convs compute in the model's compute dtype (bf16 under
bf16 compute), the norms in at least fp32, and PReLU in its input's dtype,
as the JAX modules do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import BatchNorm3d, channel_pool, conv3d, instance_norm


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class _ConvNormAct(nn.Module):
    """Shared tail of ConvNorm and DWConvNorm: norm ("BATCH" with running
    statistics, or "INSTANCE"), then PReLU when leaky, else ReLU."""

    def __init__(self, features: int, norm: str, activation: bool, leaky: bool):
        super().__init__()
        if norm not in ("BATCH", "INSTANCE"):
            raise NotImplementedError(f"norm {norm!r} is not ported yet")
        self.norm, self.activation, self.leaky = norm, activation, leaky
        if norm == "BATCH":
            self.BatchNorm_0 = BatchNorm3d(features)
        if activation and leaky:
            self.act = PReLU()

    def norm_act(self, x):
        x = self.BatchNorm_0(x) if self.norm == "BATCH" else instance_norm(x)
        if self.activation:
            x = self.act(x) if self.leaky else F.relu(x)
        return x


class ConvNorm(_ConvNormAct):
    """conv (no bias) -> norm -> activation."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 leaky: bool = True, norm: str = "BATCH", activation: bool = True):
        super().__init__(features, norm, activation, leaky)
        self.conv = conv3d(cin, features, kernel_size, stride, bias=False)

    def forward(self, x):
        return self.norm_act(self.conv(x))


class DWConvNorm(_ConvNormAct):
    """Depthwise conv + pointwise conv + norm + activation."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 leaky: bool = True, norm: str = "BATCH", activation: bool = True):
        super().__init__(features, norm, activation, leaky)
        self.dwconv = conv3d(cin, cin, kernel_size, stride, groups=cin, bias=False)
        self.pwconv = conv3d(cin, features, 1)

    def forward(self, x):
        return self.norm_act(self.pwconv(self.dwconv(x)))


class ResBlock(nn.Module):
    """Residual block; lkdw uses depthwise-separable 3^3 convs."""

    def __init__(self, cin: int, features: int, stride: int = 1, leaky: bool = False,
                 lkdw: bool = False, norm: str = "BATCH"):
        super().__init__()
        conv = DWConvNorm if lkdw else ConvNorm
        self.conv1 = conv(cin, features, 3, stride, leaky, norm, True)
        self.conv2 = conv(features, features, 3, 1, leaky, norm, lkdw)
        self.leaky = leaky
        if cin != features or stride != 1:
            self.identity = ConvNorm(cin, features, 1, stride, leaky, norm, False)
        else:
            self.identity = None
        if leaky:
            self.act = PReLU()

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        out = out + (x if self.identity is None else self.identity(x))
        return self.act(out) if self.leaky else F.relu(out)


class SpatialAttention3D(nn.Module):
    """max+mean channel pool -> k^3 conv -> sigmoid; returns the gate map."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = conv3d(2, 1, kernel_size, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.conv(channel_pool(x)))


class SkrGate(nn.Module):
    """ResBlock(lkdw) + SpatialAttention3D(k=1): one skip-return gate."""

    def __init__(self, features: int):
        super().__init__()
        self.res = ResBlock(features, features, lkdw=True)
        self.sa = SpatialAttention3D(kernel_size=1)

    def forward(self, x):
        return self.sa(self.res(x))
