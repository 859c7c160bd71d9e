"""The UxLSTM nnU-Net family, 2-D and 3-D (counterpart of
`xlstm_hved_tpu/models/uxlstm.py`).

- `ResidualXlstmEncoder` / `UNetResDecoder` / `UXlstmEnc`: residual conv
  stages with a per-stage mixer, a conv block or a ViL layer as
  `mixer_schedule` places them; a ViL stage tokenises over channels when its
  feature map has no more voxels than channels (`channel_token_schedule`).
- `UXlstmBot`: the same U-Net with one ViL, at the bottleneck.
- `build_uxlstm_from_plans`: the nets from a plain nnU-Net plans dict.

Layout is channels-first, (B, C, *spatial); 2-D and 3-D nets differ only in
their convs (`nn.blocks.Conv2d` / `Conv3d`, chosen by the spatial rank) and in
the schedules and the decoder's last join, as the JAX modules do. Submodule
and parameter names follow the flax scopes, so a converted JAX tree
(`utils/convert.py`) loads with `load_state_dict(strict=True)`.

Every conv pads k // 2 on both sides, stride 2 included (the JAX module's
explicit padding, torch's own convention). The norm is an affine instance
norm with fp32 statistics, the nonlinearity LeakyReLU(1e-2). Nearest
upsampling repeats each voxel (`repeat_interleave`, the JAX `jnp.repeat`).
The ViL mixers run in fp32 whatever the compute dtype (the fp32 island), so
the CUDA mLSTM kernels always receive fp32; `dtype` (None or
torch.bfloat16) is the convs' compute dtype, cast at the op.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from xlstm_hved_torch.nn.blocks import (Conv2d, Conv3d, at_least_fp32, leaky_relu,
                                        set_compute_dtype)
from xlstm_hved_torch.nn.vil import ViLBlock
from xlstm_hved_torch.utils.logging import span

IntOrSeq = Union[int, Sequence]


def _tuple(value, ndim: int) -> Tuple[int, ...]:
    return (value,) * ndim if isinstance(value, int) else tuple(value)


def _per_stage(value, n_stages: int) -> List:
    if isinstance(value, int):
        return [value] * n_stages
    return list(value)


def _stage_tuples(values, n_stages: int, ndim: int) -> List[Tuple[int, ...]]:
    return [_tuple(v, ndim) for v in _per_stage(values, n_stages)]


def _conv(ndim: int, cin: int, cout: int, kernel, stride=1, padding=0) -> nn.Module:
    return (Conv3d if ndim == 3 else Conv2d)(cin, cout, kernel, stride, padding)


class InstanceNormND(nn.Module):
    """Affine instance norm over every spatial axis: fp32 statistics (the
    centred two-pass variance), eps 1e-5, returned in x's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dims = tuple(range(2, x.ndim))
        x32 = at_least_fp32(x)
        mean = x32.mean(dim=dims, keepdim=True)
        var = (x32 - mean).square().mean(dim=dims, keepdim=True)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class ResBlockND(nn.Module):
    """conv-norm-act, conv-norm, plus the input (through a strided 1x1
    `conv3` when `use_1x1conv`, the width changes or the block strides),
    then act."""

    def __init__(self, ndim: int, cin: int, features: int, kernel_size: IntOrSeq = 3,
                 stride: IntOrSeq = 1, use_1x1conv: bool = False):
        super().__init__()
        ks = _tuple(kernel_size, ndim)
        st = _tuple(stride, ndim)
        pad = tuple(k // 2 for k in ks)
        self.conv1 = _conv(ndim, cin, features, ks, st, pad)
        self.norm1 = InstanceNormND(features)
        self.conv2 = _conv(ndim, features, features, ks, 1, pad)
        self.norm2 = InstanceNormND(features)
        if use_1x1conv or cin != features or any(s != 1 for s in st):
            self.conv3 = _conv(ndim, cin, features, 1, st)
        else:
            self.conv3 = None

    def forward(self, x):
        y = leaky_relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.conv3 is not None:
            x = self.conv3(x)
        return leaky_relu(y + x)


class ViLMixerND(nn.Module):
    """One ViLBlock over the voxels of a (B, C, *spatial) map (patch tokens,
    `dim` = C) or over its channels (channel tokens, `dim` = the number of
    voxels), in at least fp32 with autocast off; returns x's dtype. Its
    forward is a `span("vil.mixer")`."""

    def __init__(self, dim: int, channel_token: bool = False, chunk_size: int = 128,
                 mlstm_kernel: Optional[bool] = None):
        super().__init__()
        self.dim, self.channel_token = dim, channel_token
        self.vil = ViLBlock(dim, chunk_size, mlstm_kernel)

    def forward(self, x):
        with span("vil.mixer"), torch.autocast(device_type=x.device.type, enabled=False):
            flat = at_least_fp32(x).flatten(2)                  # (B, C, S)
            if self.channel_token:
                if flat.shape[-1] != self.dim:
                    raise ValueError(
                        f"ViLMixerND expects {self.dim} voxels as channel-token features, got "
                        f"{flat.shape[-1]}: channel_token_schedule floors each stage's map "
                        "size, so every pooled axis must halve evenly")
                y = self.vil(flat)
            else:
                if x.shape[1] != self.dim:
                    raise ValueError(f"ViLMixerND expects {self.dim} channels, got {x.shape[1]}")
                y = self.vil(flat.transpose(1, 2)).transpose(1, 2)
            return y.reshape(x.shape).to(x.dtype)


def mixer_schedule(n_stages: int, ndim: int) -> List[str]:
    """Each encoder stage's mixer: "conv", "vil" or "none". 3-D: a conv block
    on stages 0-2 and ViL from stage 3. 2-D: ViL on the stages past 1 of the
    parity that gives the last stage one, a conv block on stage 1, nothing
    elsewhere."""
    if ndim == 3:
        return ["conv" if s < 3 else "vil" for s in range(n_stages)]
    out = []
    for s in range(n_stages):
        if (s % 2 == 1) != (n_stages % 2 == 1) and s > 1:
            out.append("vil")
        elif s == 1:
            out.append("conv")
        else:
            out.append("none")
    return out


def channel_token_schedule(input_size: Sequence[int], features_per_stage: Sequence[int],
                           strides: Sequence[Sequence[int]]
                           ) -> Tuple[List[bool], List[Tuple[int, ...]]]:
    """(whether each stage tokenises over channels, each stage's map size):
    a stage takes channel tokens when its map has no more voxels than it
    has channels."""
    do_channel, sizes = [], []
    size = tuple(input_size)
    for feats, st in zip(features_per_stage, strides):
        size = tuple(i // j for i, j in zip(size, st))
        sizes.append(size)
        do_channel.append(int(np.prod(size)) <= feats)
    return do_channel, sizes


class ResidualXlstmEncoder(nn.Module):
    """A stem at full resolution (a ResBlock with a 1x1 skip, then the
    stage-0 extra blocks), then per stage a strided ResBlock, its extra
    blocks and, with `use_vil`, the scheduled mixer. Returns every stage's
    output, highest resolution first."""

    def __init__(self, input_size: Sequence[int], input_channels: int,
                 features_per_stage: Sequence[int], kernel_sizes: IntOrSeq = 3,
                 strides: IntOrSeq = 2, n_blocks_per_stage: IntOrSeq = 1,
                 use_vil: bool = True, chunk_size: int = 128,
                 mlstm_kernel: Optional[bool] = None):
        super().__init__()
        ndim = len(input_size)
        n_stages = len(features_per_stage)
        kernels = _stage_tuples(kernel_sizes, n_stages, ndim)
        strides = _stage_tuples(strides, n_stages, ndim)
        n_blocks = _per_stage(n_blocks_per_stage, n_stages)
        do_channel, fmap_sizes = channel_token_schedule(input_size, features_per_stage, strides)
        kinds = mixer_schedule(n_stages, ndim)
        self.n_stages, self.n_blocks = n_stages, n_blocks
        self.mixers = [kinds[s] if use_vil else "none" for s in range(n_stages)]

        stem_c = features_per_stage[0]
        self.stem_res = ResBlockND(ndim, input_channels, stem_c, kernels[0], 1, True)
        for b in range(n_blocks[0] - 1):
            self.add_module(f"stem_block{b}", ResBlockND(ndim, stem_c, stem_c, kernels[0]))
        cin = stem_c
        for s, feats in enumerate(features_per_stage):
            self.add_module(f"stage{s}_res",
                            ResBlockND(ndim, cin, feats, kernels[s], strides[s], True))
            for b in range(n_blocks[s] - 1):
                self.add_module(f"stage{s}_block{b}", ResBlockND(ndim, feats, feats, kernels[s]))
            if self.mixers[s] == "conv":
                self.add_module(f"mixer{s}", ResBlockND(ndim, feats, feats, kernels[s]))
            elif self.mixers[s] == "vil":
                dim = int(np.prod(fmap_sizes[s])) if do_channel[s] else feats
                self.add_module(f"mixer{s}", ViLMixerND(dim, do_channel[s], chunk_size,
                                                        mlstm_kernel))
            cin = feats

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem_res(x)
        for b in range(self.n_blocks[0] - 1):
            x = getattr(self, f"stem_block{b}")(x)
        skips = []
        for s in range(self.n_stages):
            x = getattr(self, f"stage{s}_res")(x)
            for b in range(self.n_blocks[s] - 1):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if self.mixers[s] != "none":
                x = getattr(self, f"mixer{s}")(x)
            skips.append(x)
        return skips


class UNetResDecoder(nn.Module):
    """Per stage, deepest first: nearest upsampling by the encoder's stride
    and a 1x1 conv to the skip's width (`up{s}_conv`), the skip
    concatenated (the 2-D nets' last stage takes none: the stem skip is not
    joined), a ResBlock with a 1x1 skip and the extra blocks, and a 1x1 seg
    head (`seg{s}`) on every stage with deep supervision, else on the last.
    Returns the logits highest resolution first (a list with deep
    supervision, else one tensor)."""

    def __init__(self, ndim: int, num_classes: int, features_per_stage: Sequence[int],
                 kernel_sizes: IntOrSeq = 3, strides: IntOrSeq = 2,
                 n_conv_per_stage: IntOrSeq = 1, deep_supervision: bool = False):
        super().__init__()
        n_stages = len(features_per_stage)
        kernels = _stage_tuples(kernel_sizes, n_stages, ndim)
        self.strides = _stage_tuples(strides, n_stages, ndim)
        n_conv = _per_stage(n_conv_per_stage, n_stages - 1)
        self.ndim, self.n_stages, self.n_conv = ndim, n_stages, n_conv
        self.deep_supervision = deep_supervision
        for s in range(1, n_stages):
            feats_skip = features_per_stage[-(s + 1)]
            self.add_module(f"up{s}_conv", _conv(ndim, features_per_stage[-s], feats_skip, 1))
            cin = feats_skip if self._no_skip(s) else 2 * feats_skip
            self.add_module(f"dec{s}_res",
                            ResBlockND(ndim, cin, feats_skip, kernels[-(s + 1)], 1, True))
            for b in range(n_conv[s - 1] - 1):
                self.add_module(f"dec{s}_block{b}",
                                ResBlockND(ndim, feats_skip, feats_skip, kernels[-(s + 1)]))
            if deep_supervision or s == n_stages - 1:
                self.add_module(f"seg{s}", _conv(ndim, feats_skip, num_classes, 1))

    def _no_skip(self, s: int) -> bool:
        return self.ndim == 2 and s == self.n_stages - 1

    def forward(self, skips: Sequence[torch.Tensor]):
        x = skips[-1]
        seg_outputs = []
        for s in range(1, self.n_stages):
            for ax, r in enumerate(self.strides[-s]):
                if r != 1:
                    x = x.repeat_interleave(r, dim=ax + 2)
            x = getattr(self, f"up{s}_conv")(x)
            if not self._no_skip(s):
                x = torch.cat([x, skips[-(s + 1)]], dim=1)
            x = getattr(self, f"dec{s}_res")(x)
            for b in range(self.n_conv[s - 1] - 1):
                x = getattr(self, f"dec{s}_block{b}")(x)
            if self.deep_supervision or s == self.n_stages - 1:
                seg_outputs.append(getattr(self, f"seg{s}")(x))
        seg_outputs = seg_outputs[::-1]
        return seg_outputs if self.deep_supervision else seg_outputs[0]


def _nnunet_block_caps(n_stages: int, n_blocks, n_dec) -> Tuple[list, list]:
    """nnU-Net's UxLSTM trainers cap the deep stages' block counts at 1."""
    n_blocks = _per_stage(n_blocks, n_stages)
    n_dec = _per_stage(n_dec, n_stages - 1)
    for s in range(math.ceil(n_stages / 2), n_stages):
        n_blocks[s] = 1
    for s in range(math.ceil((n_stages - 1) / 2 + 0.5), n_stages - 1):
        n_dec[s] = 1
    return n_blocks, n_dec


class _UXlstm(nn.Module):
    """The encoder ("encoder"), an optional bottleneck ViL ("xlstm") and the
    decoder ("decoder") of the two nets."""

    bottleneck_vil = False

    def __init__(self, input_size: Sequence[int], input_channels: int,
                 features_per_stage: Sequence[int], num_classes: int,
                 kernel_sizes: IntOrSeq = 3, strides: IntOrSeq = 2,
                 n_conv_per_stage: IntOrSeq = 2, n_conv_per_stage_decoder: IntOrSeq = 2,
                 deep_supervision: bool = False, chunk_size: int = 128,
                 dtype: Optional[torch.dtype] = None, mlstm_kernel: Optional[bool] = None):
        super().__init__()
        ndim = len(input_size)
        n_stages = len(features_per_stage)
        n_blocks, n_dec = _nnunet_block_caps(n_stages, n_conv_per_stage,
                                             n_conv_per_stage_decoder)
        self.encoder = ResidualXlstmEncoder(
            input_size, input_channels, features_per_stage, kernel_sizes, strides,
            tuple(n_blocks), not self.bottleneck_vil, chunk_size, mlstm_kernel)
        if self.bottleneck_vil:
            self.xlstm = ViLMixerND(features_per_stage[-1], False, chunk_size, mlstm_kernel)
        self.decoder = UNetResDecoder(ndim, num_classes, features_per_stage, kernel_sizes,
                                      strides, tuple(n_dec), deep_supervision)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        skips = self.encoder(x)
        if self.bottleneck_vil:
            skips[-1] = self.xlstm(skips[-1])
        return self.decoder(skips)


class UXlstmEnc(_UXlstm):
    """U-Net with ViL mixers on the deep encoder stages."""


class UXlstmBot(_UXlstm):
    """U-Net with a single ViL layer, on the bottleneck's output."""

    bottleneck_vil = True


def build_uxlstm_from_plans(plans: dict, num_input_channels: int, num_classes: int,
                            deep_supervision: bool = True, variant: str = "enc",
                            dtype: Optional[torch.dtype] = None,
                            mlstm_kernel: Optional[bool] = None) -> _UXlstm:
    """The net from a plain nnU-Net plans dict with the configuration fields
    the upstream factory reads: patch_size, conv_kernel_sizes,
    pool_op_kernel_sizes, n_conv_per_stage_encoder, n_conv_per_stage_decoder,
    UNet_base_num_features (default 32), unet_max_num_features (default
    320). The spatial rank follows len(conv_kernel_sizes[0]); `variant` is
    "enc" (UXlstmEnc) or "bot" (UXlstmBot)."""
    num_stages = len(plans["conv_kernel_sizes"])
    base = plans.get("UNet_base_num_features", 32)
    cap = plans.get("unet_max_num_features", 320)
    features = tuple(min(base * 2 ** i, cap) for i in range(num_stages))
    cls = {"enc": UXlstmEnc, "bot": UXlstmBot}[variant]
    return cls(
        input_size=tuple(plans["patch_size"]),
        input_channels=num_input_channels,
        features_per_stage=features,
        num_classes=num_classes,
        kernel_sizes=tuple(tuple(k) for k in plans["conv_kernel_sizes"]),
        strides=tuple(tuple(s) for s in plans["pool_op_kernel_sizes"]),
        n_conv_per_stage=tuple(plans.get("n_conv_per_stage_encoder", [2] * num_stages)),
        n_conv_per_stage_decoder=tuple(plans.get("n_conv_per_stage_decoder",
                                                 [2] * (num_stages - 1))),
        deep_supervision=deep_supervision,
        dtype=dtype,
        mlstm_kernel=mlstm_kernel,
    )
