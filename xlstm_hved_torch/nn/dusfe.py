"""DuSE cross-awareness between the recon and seg decoder branches in NCDHW
(counterpart of `xlstm_hved_tpu/nn/dusfe.py::DuSEAttention`). The dense
layers and convs compute in the model's compute dtype (flax's Dense and
conv `dtype`), the BatchNorms in at least fp32, returning the branch's
dtype."""
from __future__ import annotations

import torch
from torch import nn

from xlstm_hved_torch.nn.blocks import BatchNorm3d, Linear, conv3d


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
