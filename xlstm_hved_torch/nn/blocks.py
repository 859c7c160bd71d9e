"""Conv building blocks in NCDHW (counterpart of `xlstm_hved_tpu/nn/blocks.py`).

Every 3D conv is a cuDNN `nn.Conv3d` with torch-style symmetric padding
k // 2 (odd kernels), stride-2 included, but for the RSM gates' folded
thin 7^3 conv, which on the card is a hand-written kernel
(`ops/gate_cuda.py`). The JAX package's block-diagonal
convs over folded modality streams are grouped convs here: stream m owns
channels [m*C, (m+1)*C), the group-major order of `nn.Conv3d(groups=M)`.
Submodule names follow the flax scopes (`conv`, `Conv3DFast_0`,
`GroupNorm_0`, `block0`, `atten`, `basic`, `pre_conv`, ...) so a converted
JAX tree loads strictly.

The layer-order string places the conv (c), the norms (i InstanceNorm,
g GroupNorm, b BatchNorm) and the nonlinearities (l LeakyReLU 0.01, r ReLU,
e ELU); the conv has no bias when the order holds g or b. The basic modules
are the double conv ("double_conv"), the residual `ExtResNetBlock`
("ext_resnet", whose decoder stage runs a 1x1 `pre_conv` before the
upsampling and joins the skip by a sum) and the ViL decoder block
("double_conv_vil").

Precision follows the JAX modules' `dtype`: every `Conv3d` and `Linear`
has a `compute_dtype` (None computes in the parameters' dtype, fp32, or
fp64 when the module was cast to it), which the model sets on all of them
in one pass (`set_compute_dtype`). With `torch.bfloat16` a conv casts its
input, weight and bias to bf16 at the op and returns bf16, as flax's
`dtype=bf16` does; the parameters stay fp32. Norm statistics are taken in
at least fp32 (`at_least_fp32`), and the norms return their input's dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.ops.gate_cuda import gate_conv
from xlstm_hved_torch.parallel.mesh import data_mesh, global_sums
from xlstm_hved_torch.utils.logging import span

_ORDER_CHARS = set("cilregb")
# the folded-stream blocks normalise per channel only
_BLOCK_DIAG_ORDER_CHARS = set("cilre")
_HALF = (torch.bfloat16, torch.float16)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """`HVEDConfig.compute_dtype` / the CLIs' `--*_dtype` -> the blocks'
    `dtype`: None for "float32" (the parameters' own dtype), torch.bfloat16
    for "bfloat16"."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {name!r}: expected one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32 when it is half precision (bf16, fp16), else as it is
    (fp32, or fp64 in an fp64 run): the JAX modules' `astype(float32)`."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    return t if t is None or dtype is None else t.to(dtype)


class Conv3d(nn.Conv3d):
    """nn.Conv3d run in `compute_dtype` when it is set: input, weight and
    bias cast at the op (the weight's gradient comes back in the weight's
    dtype)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d run in `compute_dtype` when it is set (the 2-D UxLSTM nets
    and VisionLSTM's patch embedding)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class Linear(nn.Linear):
    """nn.Linear run in `compute_dtype` when it is set (flax Dense's
    `dtype`)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Every Conv3d, Conv2d and Linear in `module` computes in `dtype`, as
    the JAX model hands its `dtype` to every block. The ViL's layers (torch's
    own nn.Linear, with their own `dtype`) are not among them: the fp32
    island. Returns `module`."""
    for m in module.modules():
        if isinstance(m, (Conv3d, Conv2d, Linear)):
            m.compute_dtype = dtype
    return module


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over the spatial axes, no
    affine, statistics in at least fp32, returned in x's dtype. Half-precision
    inputs take JAX's one-pass moments E[x], E[x^2] (the variance floored at
    0); fp32 and fp64 inputs the centred two-pass variance."""
    dims = tuple(range(2, x.ndim))
    x32 = at_least_fp32(x)
    mean = x32.mean(dim=dims, keepdim=True)
    if x.dtype in _HALF:
        var = torch.clamp(x32.square().mean(dim=dims, keepdim=True) - mean.square(), min=0.0)
    else:
        var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm with the flax `nn.BatchNorm` defaults the JAX package uses.

    Training mode: the batch mean and the fast variance E[x^2] - E[x]^2
    (floored at 0), both fp32, normalise the batch with gradients through
    them; the running statistics move as flax moves them, by momentum 0.99
    (torch momentum 0.01) towards the batch mean and the BIASED batch
    variance (torch's own F.batch_norm folds in the unbiased one, n/(n-1)
    larger, visible at small spatial sizes). Eval mode is torch's, on the
    running statistics. Both reduce and normalise in at least fp32, as
    flax's BatchNorm does, and return the input's dtype. Under a data mesh
    of more than one rank the moments are the global batch's (the ranks'
    sums added before the ratios, as the sharded JAX step takes them), so
    the running statistics move alike on every rank.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps=eps, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return super().forward(at_least_fp32(x)).to(x.dtype)
        dims = (0,) + tuple(range(2, x.ndim))
        # flax casts x twice, once for the statistics and once where it is
        # centred, so its gradient comes back as two half-precision terms
        # added in x's dtype: two casts here as well
        x32 = at_least_fp32(x)
        if data_mesh() is None:
            mean = x32.mean(dim=dims)
            var = torch.clamp(x32.square().mean(dim=dims) - mean.square(), min=0.0)
        else:  # the global batch's moments: the ranks' sums, then the ratios
            count = x32.new_full((1,), x.numel() // x.shape[1])
            s1, s2, count = global_sums(x32.sum(dim=dims), x32.square().sum(dim=dims), count)
            mean = s1 / count
            var = torch.clamp(s2 / count - mean.square(), min=0.0)
        x32 = at_least_fp32(x)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm as flax's `nn.GroupNorm` computes it, in the JAX
    SingleConv's set-up: `num_groups` groups, or 1 when there are fewer
    channels than that; eps 1e-6; the fast variance E[x^2] - E[x]^2 (floored
    at 0) in at least fp32, x cast twice as flax casts it; a per-channel
    scale and bias; returned in x's dtype."""

    def __init__(self, features: int, num_groups: int = 8, eps: float = 1e-6):
        groups = num_groups if features >= num_groups else 1
        if features % groups:
            raise ValueError(f"{groups} groups do not divide {features} channels")
        super().__init__(groups, features, eps=eps)

    def forward(self, x):
        B, C = x.shape[:2]
        shape = (1, C) + (1,) * (x.ndim - 2)
        x32 = at_least_fp32(x).reshape(B, self.num_groups, -1)
        mean = x32.mean(dim=-1)
        var = torch.clamp(x32.square().mean(dim=-1) - mean.square(), min=0.0)
        stat_shape = (B, C) + (1,) * (x.ndim - 2)
        mean = mean.repeat_interleave(C // self.num_groups, dim=1).view(stat_shape)
        var = var.repeat_interleave(C // self.num_groups, dim=1).view(stat_shape)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return ((at_least_fp32(x) - mean) * mul + self.bias.view(shape)).to(x.dtype)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=1e-2)


def resize_trilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Trilinear resize of (B, C, D, H, W) to spatial `size`, half-pixel
    centres (align_corners=False), in x's dtype."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="trilinear", align_corners=False)


def max_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.max_pool3d(x, window, window)


def avg_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.avg_pool3d(x, window, window)


def conv3d(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
           groups: int = 1, bias: bool = True) -> Conv3d:
    """Conv3d with symmetric padding k // 2."""
    return Conv3d(cin, cout, kernel_size, stride, padding=kernel_size // 2,
                  groups=groups, bias=bias)


def channel_pool(x: torch.Tensor) -> torch.Tensor:
    """concat(max, mean) over channels -> 2 channels."""
    return torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)


def _order_layers(module: nn.Module, order: str, allowed: set, conv_name: str,
                  conv: nn.Module, cin: int, features: int, num_groups: int):
    """Register the conv and the order's norms on `module` under their flax
    names (GroupNorm_0, BatchNorm_0, ... counted per kind, sized by where
    they sit in the order) and return the order as a list of steps: (char,
    the submodule's name, or None for the parameter-free chars)."""
    if "c" not in order or not set(order) <= allowed:
        raise NotImplementedError(
            f"layer order {order!r}: the chars {sorted(allowed)} are supported here "
            "and the order needs a conv")
    module.add_module(conv_name, conv)
    steps, counts, channels = [], {}, cin
    for char in order:
        if char == "c":
            steps.append((char, conv_name))
            channels = features
        elif char in "gb":
            kind = "GroupNorm" if char == "g" else "BatchNorm"
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            module.add_module(name, GroupNorm(channels, num_groups) if char == "g"
                              else BatchNorm3d(channels))
            steps.append((char, name))
        else:
            steps.append((char, None))
    return steps


def _run_order(module: nn.Module, steps, x: torch.Tensor) -> torch.Tensor:
    for char, name in steps:
        if name is not None:
            x = getattr(module, name)(x)
        elif char == "i":
            x = instance_norm(x)
        elif char == "l":
            x = leaky_relu(x)
        elif char == "r":
            x = F.relu(x)
        else:  # "e"
            x = F.elu(x)
    return x


class SingleConv(nn.Module):
    """One 3^3 conv (stride `stride`) with norm/nonlinearity placement from
    the order string; no conv bias when the order normalises by group or
    batch. GroupNorm takes `num_groups` groups (1 below that many
    channels); BatchNorm follows the module's train/eval mode. With
    `streams` > 1 the conv is grouped, one group per stream of the folded
    layout (cin and features count all streams' channels), and the order
    may only normalise per channel."""

    def __init__(self, cin: int, features: int, order: str = "ilc", stride: int = 1,
                 num_groups: int = 8, streams: int = 1):
        super().__init__()
        bias = not set("gb") & set(order)
        allowed = _ORDER_CHARS if streams == 1 else _BLOCK_DIAG_ORDER_CHARS
        self.steps = _order_layers(self, order, allowed, "Conv3DFast_0",
                                   conv3d(cin, features, 3, stride, streams, bias),
                                   cin, features, num_groups)

    def forward(self, x):
        return _run_order(self, self.steps, x)


class DoubleConv(nn.Module):
    """Two SingleConvs: the encoder widens in conv2, the decoder narrows in
    conv1; conv2 strides by `pool_stride`."""

    def __init__(self, cin: int, features: int, encoder: bool = False,
                 order: str = "ilc", pool_stride: int = 1, num_groups: int = 8):
        super().__init__()
        mid = max(features // 2, cin) if encoder else features
        self.conv1 = SingleConv(cin, mid, order, num_groups=num_groups)
        self.conv2 = SingleConv(mid, features, order, pool_stride, num_groups)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class ExtResNetBlock(nn.Module):
    """conv1, then conv2 on its output, plus conv1's output as the residual
    (taken after conv1's whole order string, no nonlinearity after the sum,
    as the JAX block does). The same channel plan in the encoder and the
    decoder; conv2 strides by `pool_stride`."""

    def __init__(self, cin: int, features: int, order: str = "ilc", pool_stride: int = 1,
                 num_groups: int = 8):
        super().__init__()
        self.conv1 = SingleConv(cin, features, order, num_groups=num_groups)
        self.conv2 = SingleConv(features, features, order, pool_stride, num_groups)

    def forward(self, x):
        out = self.conv1(x)
        return self.conv2(out) + out


BASIC_MODULES = ("double_conv", "ext_resnet", "double_conv_vil")


def make_basic_module(name: str, cin: int, features: int, encoder: bool, order: str,
                      num_groups: int = 8, mlstm_kernel: Optional[bool] = None) -> nn.Module:
    """The basic module `name` from cin to features channels (the ViL
    decoder block takes `mlstm_kernel` and stays fp32)."""
    if name == "double_conv":
        return DoubleConv(cin, features, encoder, order, num_groups=num_groups)
    if name == "ext_resnet":
        return ExtResNetBlock(cin, features, order, num_groups=num_groups)
    if name == "double_conv_vil":
        from xlstm_hved_torch.nn.vil import DoubleConvViL  # vil imports this module

        return DoubleConvViL(cin, features, order, mlstm_kernel, num_groups)
    raise ValueError(f"unknown basic_module {name!r}; expected one of {BASIC_MODULES}")


class BasicConv(nn.Module):
    """Bias-free conv (grouped when groups > 1), then InstanceNorm when
    `norm` and LeakyReLU when `relu`."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1, groups: int = 1,
                 relu: bool = True, norm: bool = True):
        super().__init__()
        self.relu, self.norm = relu, norm
        self.conv = conv3d(cin, features, kernel_size, groups=groups, bias=False)

    def forward(self, x):
        x = self.conv(x)
        if self.norm:
            x = instance_norm(x)
        return leaky_relu(x) if self.relu else x


def _same_padding(n: int, kernel: int = 3, stride: int = 2):
    """flax's "SAME" padding of one axis: (lo, hi), the extra voxel high."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class EncoderStage(nn.Module):
    """2x downsampling (max or average pooling; any other `pool_type` is
    the JAX stage's 3^3 stride-2 conv `Conv_0` with "SAME" padding) when
    `apply_pooling`, then num_block basic modules ("double_conv" or
    "ext_resnet") in their encoder channel plan."""

    def __init__(self, cin: int, features: int, num_block: int = 1, order: str = "ilc",
                 basic_module: str = "double_conv", pool_type: str = "max",
                 apply_pooling: bool = True, num_groups: int = 8):
        super().__init__()
        self.pool_type = pool_type if apply_pooling else None
        if apply_pooling and pool_type not in ("max", "avg"):
            self.Conv_0 = Conv3d(cin, features, 3, 2)
            cin = features
        self.num_block = num_block
        for i in range(num_block):
            self.add_module(f"block{i}", make_basic_module(
                basic_module, cin if i == 0 else features, features, True, order, num_groups))

    def forward(self, x):
        if self.pool_type == "max":
            x = max_pool3d(x)
        elif self.pool_type == "avg":
            x = avg_pool3d(x)
        elif self.pool_type is not None:
            pads = [p for n in reversed(x.shape[2:]) for p in _same_padding(n)]
            x = self.Conv_0(F.pad(x, pads))
        for i in range(self.num_block):
            x = getattr(self, f"block{i}")(x)
        return x


def _composed_pool_gate(x, grouped: nn.Conv3d, point: nn.Conv3d, expan: int = 4):
    """The grouped 7^3 conv followed by a 1x1 conv with no nonlinearity
    between is one linear map: fold the weights (in the parameters' dtype)
    and run one thin 7^3 conv in the gate's compute dtype, a
    `span("rsm.gate")`.

        k_eff[o, m] = sum_e w7[m*E + e, 0] * w1[o, m*E + e]
        b_eff[o]    = sum_{m,e} b7[m*E + e] * w1[o, m*E + e] + b1[o]

    The thin conv is the hand-written kernel for CUDA tensors
    (`ops/gate_cuda.py`) and the F.conv3d expression, its plain twin, for
    CPU tensors."""
    with span("rsm.gate"):
        streams = grouped.in_channels
        k = grouped.kernel_size
        w7 = grouped.weight.reshape(streams, expan, *k)
        w1 = point.weight.reshape(point.out_channels, streams, expan)
        k_eff = torch.einsum("mekij,ome->omkij", w7, w1)
        b_eff = torch.einsum("me,ome->o", grouped.bias.reshape(streams, expan), w1) + point.bias
        dt = grouped.compute_dtype
        return gate_conv(_cast(x, dt), _cast(k_eff, dt), _cast(b_eff, dt))


class AttenModule2(nn.Module):
    """ROI-attentive skip fusion of the MVAE decoder. The seg branch gets a
    (1 + sigmoid) self-gate from its own channel pool; the encoder skip gets
    a sigmoid cross-gate from [seg_pool, enc_pool]; the output is
    concat(seg, enc). Each gate is a grouped 7^3 conv (4 outputs per input
    channel) then a 1x1 conv, run weight-composed."""

    def __init__(self):
        super().__init__()
        self.enc_spatial = conv3d(4, 16, 7, groups=4)
        self.enc_spatial2 = conv3d(16, 1, 1)
        self.seg_spatial = conv3d(2, 8, 7, groups=2)
        self.seg_spatial2 = conv3d(8, 1, 1)

    def forward(self, seg_x, enc_x):
        spa_comp = channel_pool(seg_x)
        enc_spa = torch.cat([spa_comp, channel_pool(enc_x)], dim=1)
        enc_scale = torch.sigmoid(
            _composed_pool_gate(enc_spa, self.enc_spatial, self.enc_spatial2))
        s_enc_x = enc_x + enc_x * enc_scale
        seg_scale = torch.sigmoid(
            _composed_pool_gate(spa_comp, self.seg_spatial, self.seg_spatial2))
        return torch.cat([seg_x * (1.0 + seg_scale), s_enc_x], dim=1)


class AttenModule(nn.Module):
    """The full RSM join of the non-MVAE decoder: per-stream sigmoid gates
    on the 4 recon and the 4 encoder feature maps from their channel pools
    beside the seg branch's, the gated recon maps compressed by a 1x1
    BasicConv (`input_comp`) to `features` and added to the gated encoder
    maps (which must have `features` channels together), the seg branch
    self-gated as in AttenModule2; returns concat(seg, recon + enc). Each
    gate pair runs weight-composed. No preset reaches it."""

    def __init__(self, recon_ch: int, features: int, streams: int = 4):
        super().__init__()
        pooled = 2 * (streams + 1)
        self.recon_spatial = conv3d(pooled, 4 * pooled, 7, groups=pooled)
        self.recon_spatial2 = conv3d(4 * pooled, streams, 1)
        self.input_comp = BasicConv(recon_ch, features, 1)
        self.enc_spatial = conv3d(pooled, 4 * pooled, 7, groups=pooled)
        self.enc_spatial2 = conv3d(4 * pooled, streams, 1)
        self.seg_spatial = conv3d(2, 8, 7, groups=2)
        self.seg_spatial2 = conv3d(8, 1, 1)

    @staticmethod
    def _gated(feats, spa_comp, grouped, point):
        spa = torch.cat([spa_comp] + [channel_pool(f) for f in feats], dim=1)
        scale = torch.sigmoid(_composed_pool_gate(spa, grouped, point))
        return torch.cat([f + f * scale[:, i:i + 1] for i, f in enumerate(feats)], dim=1)

    def forward(self, seg_x, enc_x: Sequence[torch.Tensor], recon_x: Sequence[torch.Tensor]):
        spa_comp = channel_pool(seg_x)
        comp_x = self.input_comp(
            self._gated(recon_x, spa_comp, self.recon_spatial, self.recon_spatial2))
        s_enc = self._gated(enc_x, spa_comp, self.enc_spatial, self.enc_spatial2)
        seg_scale = torch.sigmoid(
            _composed_pool_gate(spa_comp, self.seg_spatial, self.seg_spatial2))
        return torch.cat([seg_x * (1.0 + seg_scale), comp_x + s_enc], dim=1)


class DecoderStage(nn.Module):
    """Trilinear upsample to the skip's size (or to `up_size` when there is
    no skip), the join, then the basic module.

    The join: with `rsm`, AttenModule2 for the MVAE seg decoder (`mvae`,
    the default) or AttenModule over per-modality lists of encoder and
    recon features (`recon_ch` channels in all); without, concat(skips, x)
    for the double convs (a list of per-modality skips is concatenated in
    its order) and skip + x for "ext_resnet", whose 1x1 `pre_conv` (with a
    bias) first brings x to `features` channels, before the upsampling.
    `skip_ch` is the skips' channel count in all (0 for none)."""

    def __init__(self, cin: int, skip_ch: int, features: int, rsm: bool = False,
                 order: str = "ilc", basic_module: str = "double_conv",
                 mlstm_kernel: Optional[bool] = None, mvae: bool = True,
                 num_groups: int = 8, recon_ch: int = 0):
        super().__init__()
        self.rsm, self.mvae = rsm, mvae
        self.residual = basic_module == "ext_resnet"
        if self.residual:
            self.pre_conv = conv3d(cin, features, 1)
            cin = features
        if rsm and mvae:
            self.atten = AttenModule2()
        elif rsm:
            self.atten = AttenModule(recon_ch, features)
            skip_ch = features
        if self.residual and not rsm:
            if skip_ch not in (0, features):
                raise ValueError(f"a sum join needs the skip at {features} channels, "
                                 f"got {skip_ch}")
            skip_ch = 0
        self.basic = make_basic_module(basic_module, cin + skip_ch, features, False, order,
                                       num_groups, mlstm_kernel)

    def forward(self, encoder_features, x, up_size=None, recon_features=None):
        if self.residual:
            x = self.pre_conv(x)
        listed = isinstance(encoder_features, (list, tuple))
        if encoder_features is None:
            target = up_size
        else:
            target = (encoder_features[0] if listed else encoder_features).shape[2:]
        x = resize_trilinear(x, target)
        if self.rsm and self.mvae:
            x = self.atten(x, encoder_features)
        elif self.rsm:
            if not (listed and isinstance(recon_features, (list, tuple))):
                raise ValueError("the non-MVAE RSM join needs per-modality encoder and "
                                 "recon feature lists")
            x = self.atten(x, encoder_features, recon_features)
        elif encoder_features is not None:
            if self.residual:
                x = encoder_features + x
            else:
                feats = list(encoder_features) if listed else [encoder_features]
                x = torch.cat(feats + [x], dim=1)
        return self.basic(x)


def block_diag_conv(streams: int, cin: int, features: int, kernel_size: int = 3,
                    stride: int = 1) -> Conv3d:
    """M independent per-stream convs on the folded (B, M*cin, ...) layout:
    a grouped conv with groups = M."""
    return conv3d(streams * cin, streams * features, kernel_size, stride, streams)


class BlockDiagSingleConv(nn.Module):
    """SingleConv per stream on the folded layout (conv with a bias; the
    order's norm is InstanceNorm only, per channel and so per stream)."""

    def __init__(self, streams: int, cin: int, features: int, stride: int = 1,
                 order: str = "ilc"):
        super().__init__()
        self.steps = _order_layers(self, order, _BLOCK_DIAG_ORDER_CHARS, "conv",
                                   block_diag_conv(streams, cin, features, 3, stride),
                                   streams * cin, streams * features, 1)

    def forward(self, x):
        return _run_order(self, self.steps, x)


class BlockDiagDoubleConv(nn.Module):
    """DoubleConv per stream on the folded layout."""

    def __init__(self, streams: int, cin: int, features: int, encoder: bool = False,
                 order: str = "ilc"):
        super().__init__()
        mid = max(features // 2, cin) if encoder else features
        self.conv1 = BlockDiagSingleConv(streams, cin, mid, 1, order)
        self.conv2 = BlockDiagSingleConv(streams, mid, features, 1, order)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class BlockDiagExtResNetBlock(nn.Module):
    """ExtResNetBlock per stream on the folded layout."""

    def __init__(self, streams: int, cin: int, features: int, order: str = "ilc"):
        super().__init__()
        self.conv1 = BlockDiagSingleConv(streams, cin, features, 1, order)
        self.conv2 = BlockDiagSingleConv(streams, features, features, 1, order)

    def forward(self, x):
        out = self.conv1(x)
        return self.conv2(out) + out


class BlockDiagEncoderStage(nn.Module):
    """EncoderStage per stream on the folded layout: 2x max-pool when
    `apply_pooling`, then num_block BlockDiagDoubleConv ("double_conv") or
    BlockDiagExtResNetBlock ("ext_resnet") blocks."""

    def __init__(self, streams: int, cin: int, features: int, num_block: int = 1,
                 apply_pooling: bool = True, order: str = "ilc",
                 basic_module: str = "double_conv"):
        super().__init__()
        self.apply_pooling = apply_pooling
        self.num_block = num_block
        for i in range(num_block):
            c = cin if i == 0 else features
            self.add_module(f"block{i}", (
                BlockDiagExtResNetBlock(streams, c, features, order)
                if basic_module == "ext_resnet"
                else BlockDiagDoubleConv(streams, c, features, True, order)))

    def forward(self, x):
        if self.apply_pooling:
            x = max_pool3d(x)
        for i in range(self.num_block):
            x = getattr(self, f"block{i}")(x)
        return x
