"""Discriminator building block in NCDHW (counterpart of
`xlstm_hved_tpu/nn/gates.py::DiscriminatorBlock`). The conv is named
`Conv_0` after the flax scope, so a converted JAX tree loads strictly. The
conv computes in the discriminator's compute dtype, InstanceNorm in at
least fp32."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import Conv3d, instance_norm

# explicit padding 1 on every side, for every kernel size (the even k = 4
# of the discriminator included)
DISC_PADDING = 1


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
