"""Initialisation schemes of the train step (counterpart of
`xlstm_hved_tpu/nn/init_schemes.py` and of the flax initialisers that
`create_train_state` starts from). Both redraw a built module's parameters
in place from a `torch.Generator` (CPU draws, copied to the parameter's
device), the same distributions as the JAX package, not the same draws.

`default_init`, the flax initialisers of the JAX modules:
  - plain Conv3d (the JAX Conv3DFast): he-normal, truncated at 2 sigma;
    the pointwise convs the JAX package builds as Conv1x1, and the
    discriminator's convs: lecun-normal, truncated; grouped Conv3d (the JAX
    block-diagonal convs): N(0, 2 / per-group fan-in); biases 0;
  - Linear outside the ViL block (DuSE fc_*, the gates' Dense_*):
    lecun-normal, bias 0;
  - the ViL causal Conv1d: lecun-normal, bias 0; the rest of the ViL block
    keeps its construction init, which already mirrors the JAX xLSTM init;
  - BatchNorm and GroupNorm weight 1, bias 0; PReLU 0.25.

`reference_init`, the train CLI's default (the upstream `init_weights`):
  - every Conv3d: kaiming-normal weights with the fan-in the conv would have
    without groups, in_channels * k^3 (what the JAX function computes for
    the block-diagonal kernels: it counts the fan-in over all streams),
    biases N(0, 1);
  - every Linear (DuSE fc_*, ViL igate, fgate, proj_up, proj_down):
    xavier-normal weights, biases N(0, 1), but the gates' `Dense_*`
    (ChannelGate, ModalityGate): the JAX function knows the upstream Linear
    layers by name and these names are not among them, so it draws them as
    it draws convs, kaiming-normal with fan-in in_features, biases N(0, 1);
  - BatchNorm weight N(1, 0.02), bias 0;
  - the ViL Conv1d, the headwise projections, GroupNorm, the other norm
    weights and PReLU are left as they are.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from xlstm_hved_torch.nn.blocks import BatchNorm3d, GroupNorm
from xlstm_hved_torch.nn.skr import PReLU
from xlstm_hved_torch.nn.vil import CausalConv1d, ViLLayer3D

# JAX Conv1x1 modules among the port's plain 1x1x1 Conv3d (by the last part
# of the module name); every other plain Conv3d is a Conv3DFast
_LECUN_CONVS = ("x0_init", "rfinal_", "sfinal_", "final_conv", "pwconv",
                "conv_squeeze_", "conv_comb", "enc_spatial2", "seg_spatial2",
                "recon_spatial2", "pre_conv", "Conv_0")
# flax truncates its normal initialisers at 2 sigma and rescales so that the
# drawn values keep the target std
_TRUNC_STD = 0.87962566103423978


def _fill(param: torch.Tensor, draw, generator: torch.Generator):
    with torch.no_grad():
        sample = torch.empty(param.shape, dtype=torch.float32)
        draw(sample, generator)
        param.copy_(sample)


def _normal(std: float, mean: float = 0.0):
    return lambda t, g: t.normal_(mean, std, generator=g)


def _truncated(variance: float):
    std = math.sqrt(variance) / _TRUNC_STD
    return lambda t, g: nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                              generator=g)


def _zero(t, g):
    t.zero_()


def _fan_in(weight: torch.Tensor) -> int:
    return weight[0].numel()


def default_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw `module`'s parameters with the JAX modules' flax initialisers."""
    from xlstm_hved_torch.models.hved import Discriminator

    lecun_all = isinstance(module, Discriminator)
    vil = {id(m) for v in module.modules() if isinstance(v, ViLLayer3D)
           for m in v.modules()}
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv3d):
            fan = _fan_in(m.weight)
            if m.groups > 1:
                draw = _normal(math.sqrt(2.0 / fan))
            elif lecun_all or name.rsplit(".", 1)[-1].startswith(_LECUN_CONVS):
                draw = _truncated(1.0 / fan)
            else:
                draw = _truncated(2.0 / fan)
            _fill(m.weight, draw, generator)
        elif isinstance(m, CausalConv1d):
            _fill(m.conv.weight, _truncated(1.0 / _fan_in(m.conv.weight)), generator)
            _fill(m.conv.bias, _zero, generator)
            continue
        elif isinstance(m, nn.Linear) and id(m) not in vil:
            _fill(m.weight, _truncated(1.0 / m.in_features), generator)
        elif isinstance(m, (BatchNorm3d, GroupNorm)):
            _fill(m.weight, lambda t, g: t.fill_(1.0), generator)
        elif isinstance(m, PReLU):
            _fill(m.weight, lambda t, g: t.fill_(0.25), generator)
            continue
        else:
            continue
        if getattr(m, "bias", None) is not None:
            _fill(m.bias, _zero, generator)
    return module


def reference_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw `module`'s parameters with the upstream init_weights
    distribution as the JAX `reference_init` applies it."""
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv3d):
            fan = m.in_channels * math.prod(m.kernel_size)
            _fill(m.weight, _normal(math.sqrt(2.0 / fan)), generator)
        elif isinstance(m, nn.Linear) and name.rsplit(".", 1)[-1].startswith("Dense_"):
            _fill(m.weight, _normal(math.sqrt(2.0 / m.in_features)), generator)
        elif isinstance(m, nn.Linear):
            std = math.sqrt(2.0 / (m.in_features + m.out_features))
            _fill(m.weight, _normal(std), generator)
        elif isinstance(m, BatchNorm3d):
            _fill(m.weight, _normal(0.02, mean=1.0), generator)
            _fill(m.bias, _zero, generator)
            continue
        else:
            continue
        if m.bias is not None:
            _fill(m.bias, _normal(1.0), generator)
    return module


INIT_SCHEMES = {"default": default_init, "reference": reference_init}
