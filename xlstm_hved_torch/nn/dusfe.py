"""DuSE cross-awareness between the recon and seg decoder branches, and the
auxiliary dense blocks and registration head, in NCDHW (counterpart of
`xlstm_hved_tpu/nn/dusfe.py`). The dense layers and convs compute in the
model's compute dtype (flax's Dense and conv `dtype`), the BatchNorms in at
least fp32, returning the branch's dtype. BatchNorm follows the module's
train / eval mode."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import BatchNorm3d, Linear, avg_pool3d, conv3d


class DuSEAttention(nn.Module):
    """Two branches (x1 recon features, x2 seg features), each C channels:
    (1) spatial squeeze (global mean) -> shared FC -> per-branch sigmoid
        channel excitation;
    (2) channel squeeze (1x1 conv to 1 channel per branch) -> fuse ->
        per-branch 3^3 conv sigmoid spatial excitation;
    (3) per-branch BatchNorm(x + channel-excited + spatially-excited).
    """

    def __init__(self, features: int):
        super().__init__()
        c = features
        self.fc_comb = Linear(2 * c, c)
        self.fc_ch1 = Linear(c, c)
        self.fc_ch2 = Linear(c, c)
        self.conv_squeeze_ch1 = conv3d(c, 1, 1)
        self.conv_squeeze_ch2 = conv3d(c, 1, 1)
        self.conv_comb = conv3d(2, 1, 1)
        self.conv_adjust_ch1 = conv3d(1, 1, 3)
        self.conv_adjust_ch2 = conv3d(1, 1, 3)
        self.bn_fuse_ch1 = BatchNorm3d(c)
        self.bn_fuse_ch2 = BatchNorm3d(c)

    def forward(self, x1, x2):
        dims = (2, 3, 4)
        comb = self.fc_comb(torch.cat([x1.mean(dim=dims), x2.mean(dim=dims)], dim=-1))
        g1 = torch.sigmoid(self.fc_ch1(comb))[:, :, None, None, None]
        g2 = torch.sigmoid(self.fc_ch2(comb))[:, :, None, None, None]

        fused = self.conv_comb(torch.cat([self.conv_squeeze_ch1(x1),
                                          self.conv_squeeze_ch2(x2)], dim=1))
        a1 = torch.sigmoid(self.conv_adjust_ch1(fused))
        a2 = torch.sigmoid(self.conv_adjust_ch2(fused))

        y1 = self.bn_fuse_ch1(x1 + x1 * g1 + x1 * a1)
        y2 = self.bn_fuse_ch2(x2 + x2 * g2 + x2 * a2)
        return y1, y2


class MakeDense(nn.Module):
    """Dense growth: concat(x, ReLU(BatchNorm(3^3 bias-free conv(x)))), the
    conv `growth` wide."""

    def __init__(self, cin: int, growth: int, use_bn: bool = True):
        super().__init__()
        self.Conv3DFast_0 = conv3d(cin, growth, 3, bias=False)
        self.BatchNorm_0 = BatchNorm3d(growth) if use_bn else None

    def forward(self, x):
        y = self.Conv3DFast_0(x)
        if self.BatchNorm_0 is not None:
            y = self.BatchNorm_0(y)
        return torch.cat([x, F.relu(y)], dim=1)


class RDB(nn.Module):
    """Residual dense block: `num_dense` MakeDense growths, then a bias-free
    1x1 `conv_1x1` back to `features` channels, plus the input."""

    def __init__(self, features: int, num_dense: int = 4, growth: int = 32):
        super().__init__()
        self.num_dense = num_dense
        for i in range(num_dense):
            self.add_module(f"dense{i}", MakeDense(features + i * growth, growth))
        self.conv_1x1 = conv3d(features + num_dense * growth, features, 1, bias=False)

    def forward(self, x):
        y = x
        for i in range(self.num_dense):
            y = getattr(self, f"dense{i}")(y)
        return self.conv_1x1(y) + x


class DuRegisterDuSE(nn.Module):
    """Dual-branch rigid-registration head: per branch a 3^3 conv + BatchNorm
    + ReLU stem, three levels of (RDB per branch, DuSE cross-talk, 2x average
    pooling), the branches concatenated through an RDB and two 3^3 convs to
    16 channels, flattened channels-last (the JAX module's NDHWC order) into
    an MLP emitting `out_params` transform parameters. The JAX module infers
    fc1's width from the volume; here it is `img_size`, the (D, H, W) of
    both inputs (upstream's default 80x80x40: fc1 16 * 10 * 10 * 5 wide)."""

    def __init__(self, features: int = 32, out_params: int = 6, in_channels: int = 1,
                 img_size: Sequence[int] = (80, 80, 40)):
        super().__init__()
        c = features
        self.img_size = tuple(img_size)
        for b in (1, 2):
            self.add_module(f"conv_in_c{b}", conv3d(in_channels, c, 3))
            self.add_module(f"bn_in_c{b}", BatchNorm3d(c))
        for lvl in range(3):
            self.add_module(f"rdb{lvl}_c1", RDB(c))
            self.add_module(f"rdb{lvl}_c2", RDB(c))
            self.add_module(f"duse{lvl}", DuSEAttention(c))
        self.rdb_comb = RDB(2 * c, growth=64)
        self.conv1_comb = conv3d(2 * c, c, 3)
        self.bn1_comb = BatchNorm3d(c)
        self.conv2_comb = conv3d(c, 16, 3)
        flat = 16
        for n in self.img_size:
            flat *= n // 8
        self.fc1 = Linear(flat, 1024)
        self.fc2 = Linear(1024, 128)
        self.fc3 = Linear(128, 16)
        self.fc4 = Linear(16, out_params)

    def forward(self, x1, x2):
        if tuple(x1.shape[2:]) != self.img_size or tuple(x2.shape[2:]) != self.img_size:
            raise ValueError(f"DuRegisterDuSE was built for inputs of {self.img_size}, got "
                             f"{tuple(x1.shape[2:])} and {tuple(x2.shape[2:])}")
        x1 = F.relu(self.bn_in_c1(self.conv_in_c1(x1)))
        x2 = F.relu(self.bn_in_c2(self.conv_in_c2(x2)))
        for lvl in range(3):
            x1 = getattr(self, f"rdb{lvl}_c1")(x1)
            x2 = getattr(self, f"rdb{lvl}_c2")(x2)
            x1, x2 = getattr(self, f"duse{lvl}")(x1, x2)
            x1, x2 = avg_pool3d(x1), avg_pool3d(x2)
        comb = self.rdb_comb(torch.cat([x1, x2], dim=1))
        comb = F.relu(self.bn1_comb(self.conv1_comb(comb)))
        comb = self.conv2_comb(comb)
        flat = comb.permute(0, 2, 3, 4, 1).reshape(comb.shape[0], -1)
        return self.fc4(self.fc3(self.fc2(self.fc1(flat))))
