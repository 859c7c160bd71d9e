"""Skip-return gate blocks and the auxiliary attention heads in NCDHW
(counterpart of `xlstm_hved_tpu/nn/skr.py`): ConvNorm (a plain or, with
`deform`, a deformable conv), DWConvNorm, ResBlock, SpatialAttention3D and
SkrGate, which the flagship's skip-return chain runs, and ResFormerBlock,
ResBottleneck, ScaleUpsample, AttentionConnection, AttentionGate,
ParallelDecoder, FCNHead and SENet3D, which no preset reaches. Every conv
pads k // 2 on both sides at any stride, as the JAX blocks' Conv3DFast does;
resizes are trilinear with half-pixel centres.

BatchNorm (`nn.blocks.BatchNorm3d`, eps 1e-5) follows the module's mode:
running statistics in eval mode, loaded from the flax `batch_stats` by
`utils/convert.py`; batch statistics with flax's running-stat update in
training mode. The convs compute in the model's compute dtype (bf16 under
bf16 compute), the norms in at least fp32, and PReLU in its input's dtype,
as the JAX modules do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import (BatchNorm3d, Linear, channel_pool, conv3d,
                                        instance_norm, resize_trilinear)
from xlstm_hved_torch.ops.deform import DeformConv3d


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class _ConvNormAct(nn.Module):
    """Shared tail of ConvNorm and DWConvNorm: norm ("BATCH" with running
    statistics, "INSTANCE", or none for any other value, as the JAX blocks
    read it), then PReLU when leaky, else ReLU, when `activation`."""

    def __init__(self, features: int, norm: str, activation: bool, leaky: bool):
        super().__init__()
        self.norm, self.activation, self.leaky = norm, activation, leaky
        if norm == "BATCH":
            self.BatchNorm_0 = BatchNorm3d(features)
        if activation and leaky:
            self.act = PReLU()

    def norm_act(self, x):
        if self.norm == "BATCH":
            x = self.BatchNorm_0(x)
        elif self.norm == "INSTANCE":
            x = instance_norm(x)
        if self.activation:
            x = self.act(x) if self.leaky else F.relu(x)
        return x


class ConvNorm(_ConvNormAct):
    """conv (no bias; a DeformConv3d when `deform`) -> norm -> activation."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 leaky: bool = True, norm: str = "BATCH", activation: bool = True,
                 deform: bool = False):
        super().__init__(features, norm, activation, leaky)
        self.conv = (DeformConv3d(cin, features, kernel_size, stride) if deform
                     else conv3d(cin, features, kernel_size, stride, bias=False))

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


class _Residual(nn.Module):
    """Shared tail of the residual blocks: the input, through a 1x1 ConvNorm
    `identity` without activation when the width or the stride changes,
    added to the branch's output, then PReLU when leaky, else ReLU."""

    def _tail(self, cin: int, features: int, stride: int, leaky: bool, norm: str):
        self.leaky = leaky
        self.identity = (ConvNorm(cin, features, 1, stride, leaky, norm, False)
                         if cin != features or stride != 1 else None)
        if leaky:
            self.act = PReLU()

    def residual(self, out, x):
        out = out + (x if self.identity is None else self.identity(x))
        return self.act(out) if self.leaky else F.relu(out)


class ResBlock(_Residual):
    """Residual block; lkdw uses depthwise-separable 3^3 convs."""

    def __init__(self, cin: int, features: int, stride: int = 1, leaky: bool = False,
                 lkdw: bool = False, norm: str = "BATCH"):
        super().__init__()
        conv = DWConvNorm if lkdw else ConvNorm
        self.conv1 = conv(cin, features, 3, stride, leaky, norm, True)
        self.conv2 = conv(features, features, 3, 1, leaky, norm, lkdw)
        self._tail(cin, features, stride, leaky, norm)

    def forward(self, x):
        return self.residual(self.conv2(self.conv1(x)), x)


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


class ResFormerBlock(_Residual):
    """A ResBlock that also returns its first conv's activation: (mid, out).
    Only conv1 may be deformable (`deform`, without `lkdw`)."""

    def __init__(self, cin: int, features: int, stride: int = 1, leaky: bool = False,
                 lkdw: bool = False, norm: str = "BATCH", deform: bool = False):
        super().__init__()
        if lkdw:
            self.conv1 = DWConvNorm(cin, features, 3, stride, leaky, norm, True)
            self.conv2 = DWConvNorm(features, features, 3, 1, leaky, norm, True)
        else:
            self.conv1 = ConvNorm(cin, features, 3, stride, leaky, norm, True, deform)
            self.conv2 = ConvNorm(features, features, 3, 1, leaky, norm, False)
        self._tail(cin, features, stride, leaky, norm)

    def forward(self, x):
        mid = self.conv1(x)
        return mid, self.residual(self.conv2(mid), x)


class ResBottleneck(_Residual):
    """1x1 -> 3^3 (stride `stride`) -> 1x1 residual bottleneck, middle width
    max(cin // 4, 1)."""

    def __init__(self, cin: int, features: int, stride: int = 1, leaky: bool = False,
                 norm: str = "BATCH"):
        super().__init__()
        mid = max(cin // 4, 1)
        self.conv1 = ConvNorm(cin, mid, 1, 1, leaky, norm, True)
        self.conv2 = ConvNorm(mid, mid, 3, stride, leaky, norm, True)
        self.conv3 = ConvNorm(mid, features, 1, 1, leaky, norm, False)
        self._tail(cin, features, stride, leaky, norm)

    def forward(self, x):
        return self.residual(self.conv3(self.conv2(self.conv1(x))), x)


class ScaleUpsample(nn.Module):
    """Trilinear upsampling by `scale_factor`; with `use_deconv` a 3^3 conv
    with a bias (to `features`, default cin) follows, the JAX module's
    stand-in for upstream's ConvTranspose3d."""

    def __init__(self, cin: int, scale_factor: int = 2, use_deconv: bool = False,
                 features: Optional[int] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = conv3d(cin, features or cin, 3) if use_deconv else None

    def forward(self, x):
        y = resize_trilinear(x, [n * self.scale_factor for n in x.shape[2:]])
        return y if self.conv is None else self.conv(y)


class AttentionConnection(nn.Module):
    """(factor + attention) * feature, with a learnable factor of shape (1,)."""

    def __init__(self, factor: float = 1.0):
        super().__init__()
        self.factor = nn.Parameter(torch.full((1,), factor))

    def forward(self, feature, attention):
        return (self.factor + attention) * feature


class AttentionGate(nn.Module):
    """Additive attention gate on a skip: the gate signal g (coarse) through
    1x1 `w_g`, the skip x through 1x1 `w_x` at stride 2, ReLU of the sum, a
    1x1 `psi` to one channel and a sigmoid, resized to x's size and applied
    to x."""

    def __init__(self, g_ch: int, x_ch: int, features_int: int, norm: str = "BATCH"):
        super().__init__()
        self.w_g = ConvNorm(g_ch, features_int, 1, 1, norm=norm, activation=False)
        self.w_x = ConvNorm(x_ch, features_int, 1, 2, norm=norm, activation=False)
        self.psi = ConvNorm(features_int, 1, 1, 1, norm=norm, activation=False)

    def forward(self, g, x):
        psi = torch.sigmoid(self.psi(F.relu(self.w_g(g) + self.w_x(x))))
        return x * resize_trilinear(psi, x.shape[2:])


class ParallelDecoder(nn.Module):
    """Three-scale fusion head at the finest scale (x3's): each scale to
    max(ch3 // 2, 1) channels by a 1x1 PReLU ConvNorm (the coarser two
    resized first), fused coarse to fine by 3^3 ConvNorms over concats, the
    three concatenated and a 1x1 `conv_out`."""

    def __init__(self, ch3: int, ch4: int, ch5: int, out_features: int, norm: str = "BATCH"):
        super().__init__()
        mid = max(ch3 // 2, 1)
        self.conv3_0 = ConvNorm(ch3, mid, 1, norm=norm)
        self.conv4_0 = ConvNorm(ch4, mid, 1, norm=norm)
        self.conv5_0 = ConvNorm(ch5, mid, 1, norm=norm)
        self.conv4_5 = ConvNorm(2 * mid, mid, 3, norm=norm)
        self.conv3_4 = ConvNorm(2 * mid, mid, 3, norm=norm)
        self.conv_out = conv3d(3 * mid, out_features, 1)

    def forward(self, x3, x4, x5):
        size = x3.shape[2:]
        f3 = self.conv3_0(x3)
        f4 = self.conv4_0(resize_trilinear(x4, size))
        level5 = self.conv5_0(resize_trilinear(x5, size))
        level4 = self.conv4_5(torch.cat([f4, level5], dim=1))
        level3 = self.conv3_4(torch.cat([f3, level4], dim=1))
        return self.conv_out(torch.cat([level3, level4, level5], dim=1))


class FCNHead(nn.Module):
    """Coarse-to-fine refinement head: x5 resized to x4's scale and brought
    to ch4 channels, added to x4 and refined by a 3^3 ConvNorm; that resized
    to x3's scale and brought to ch3, added to x3 and refined; a 1x1
    `conv_out`. PReLU ConvNorms throughout."""

    def __init__(self, ch3: int, ch4: int, ch5: int, out_features: int, norm: str = "BATCH"):
        super().__init__()
        self.conv5_4 = ConvNorm(ch5, ch4, 1, norm=norm)
        self.conv4_0 = ConvNorm(ch4, ch4, 3, norm=norm)
        self.conv4_3 = ConvNorm(ch4, ch3, 1, norm=norm)
        self.conv3_0 = ConvNorm(ch3, ch3, 3, norm=norm)
        self.conv_out = conv3d(ch3, out_features, 1)

    def forward(self, x3, x4, x5):
        x4_ref = self.conv4_0(self.conv5_4(resize_trilinear(x5, x4.shape[2:])) + x4)
        x3_ref = self.conv3_0(self.conv4_3(resize_trilinear(x4_ref, x3.shape[2:])) + x3)
        return self.conv_out(x3_ref)


class SENet3D(nn.Module):
    """Channel squeeze-excitation: the global mean, bias-free `fc1` to
    max(channels // ratio, 1), ReLU, bias-free `fc2`, a sigmoid gate."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.fc1 = Linear(channels, hidden, bias=False)
        self.fc2 = Linear(hidden, channels, bias=False)

    def forward(self, x):
        gate = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3, 4))))))
        return x * gate[:, :, None, None, None]
