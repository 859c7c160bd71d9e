"""Conv building blocks in NCDHW (counterpart of `xlstm_hved_tpu/nn/blocks.py`).

Every 3D conv is a cuDNN `nn.Conv3d` with torch-style symmetric padding
k // 2 (odd kernels), stride-2 included. The JAX package's block-diagonal
convs over folded modality streams are grouped convs here: stream m owns
channels [m*C, (m+1)*C), the group-major order of `nn.Conv3d(groups=M)`.
Submodule names follow the flax scopes (`conv`, `Conv3DFast_0`, `block0`,
`atten`, `basic`, ...) so a converted JAX tree loads strictly.

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

_ORDER_CHARS = set("cil")
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


class Linear(nn.Linear):
    """nn.Linear run in `compute_dtype` when it is set (flax Dense's
    `dtype`)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Every Conv3d and Linear in `module` computes in `dtype`, as the JAX
    model hands its `dtype` to every block. The ViL's layers (torch's own
    nn.Linear) are not among them: the fp32 island. Returns `module`."""
    for m in module.modules():
        if isinstance(m, (Conv3d, Linear)):
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
    flax's BatchNorm does, and return the input's dtype.
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
        mean = x32.mean(dim=dims)
        var = torch.clamp(x32.square().mean(dim=dims) - mean.square(), min=0.0)
        x32 = at_least_fp32(x)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


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


def conv3d(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
           groups: int = 1, bias: bool = True) -> Conv3d:
    """Conv3d with symmetric padding k // 2."""
    return Conv3d(cin, cout, kernel_size, stride, padding=kernel_size // 2,
                  groups=groups, bias=bias)


def channel_pool(x: torch.Tensor) -> torch.Tensor:
    """concat(max, mean) over channels -> 2 channels."""
    return torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)


def _check_order(order: str):
    if "c" not in order or not set(order) <= _ORDER_CHARS:
        raise NotImplementedError(
            f"layer order {order!r}: the port supports the chars {sorted(_ORDER_CHARS)} "
            "and needs a conv")


def _apply_order(order: str, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    for char in order:
        if char == "c":
            x = conv(x)
        elif char == "i":
            x = instance_norm(x)
        else:  # "l"
            x = leaky_relu(x)
    return x


class SingleConv(nn.Module):
    """One conv with norm/nonlinearity placement from the order string
    (c conv, i InstanceNorm, l LeakyReLU; every preset uses "ilc")."""

    def __init__(self, cin: int, features: int, order: str = "ilc"):
        super().__init__()
        _check_order(order)
        self.order = order
        self.Conv3DFast_0 = conv3d(cin, features, 3)

    def forward(self, x):
        return _apply_order(self.order, self.Conv3DFast_0, x)


class DoubleConv(nn.Module):
    """Two SingleConvs: the encoder widens in conv2, the decoder narrows in
    conv1."""

    def __init__(self, cin: int, features: int, encoder: bool = False,
                 order: str = "ilc"):
        super().__init__()
        mid = max(features // 2, cin) if encoder else features
        self.conv1 = SingleConv(cin, mid, order)
        self.conv2 = SingleConv(mid, features, order)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class BasicConv(nn.Module):
    """Bias-free conv (grouped when groups > 1) + InstanceNorm + LeakyReLU."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1, groups: int = 1):
        super().__init__()
        self.conv = conv3d(cin, features, kernel_size, groups=groups, bias=False)

    def forward(self, x):
        return leaky_relu(instance_norm(self.conv(x)))


class EncoderStage(nn.Module):
    """2x max-pool + num_block encoder DoubleConvs."""

    def __init__(self, cin: int, features: int, num_block: int = 1, order: str = "ilc"):
        super().__init__()
        self.num_block = num_block
        for i in range(num_block):
            self.add_module(f"block{i}", DoubleConv(cin if i == 0 else features, features,
                                                    True, order))

    def forward(self, x):
        x = max_pool3d(x)
        for i in range(self.num_block):
            x = getattr(self, f"block{i}")(x)
        return x


def _composed_pool_gate(x, grouped: nn.Conv3d, point: nn.Conv3d, expan: int = 4):
    """The grouped 7^3 conv followed by a 1x1 conv with no nonlinearity
    between is one linear map: fold the weights (in the parameters' dtype)
    and run one thin 7^3 conv in the gate's compute dtype.

        k_eff[o, m] = sum_e w7[m*E + e, 0] * w1[o, m*E + e]
        b_eff[o]    = sum_{m,e} b7[m*E + e] * w1[o, m*E + e] + b1[o]
    """
    streams = grouped.in_channels
    k = grouped.kernel_size
    w7 = grouped.weight.reshape(streams, expan, *k)
    w1 = point.weight.reshape(point.out_channels, streams, expan)
    k_eff = torch.einsum("mekij,ome->omkij", w7, w1)
    b_eff = torch.einsum("me,ome->o", grouped.bias.reshape(streams, expan), w1) + point.bias
    dt = grouped.compute_dtype
    return F.conv3d(_cast(x, dt), _cast(k_eff, dt), _cast(b_eff, dt), padding=k[0] // 2)


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


class DecoderStage(nn.Module):
    """Trilinear upsample to the skip's size, join (AttenModule2 for the
    MVAE seg decoder, else concat(skip, x)), then the basic module: a decoder
    DoubleConv ("double_conv"), or `nn.vil.DoubleConvViL`
    ("double_conv_vil", whose ViL takes `mlstm_kernel` and stays fp32)."""

    def __init__(self, cin: int, skip_ch: int, features: int, rsm: bool = False,
                 order: str = "ilc", basic_module: str = "double_conv",
                 mlstm_kernel: Optional[bool] = None):
        super().__init__()
        self.rsm = rsm
        if rsm:
            self.atten = AttenModule2()
        if basic_module == "double_conv":
            self.basic = DoubleConv(cin + skip_ch, features, False, order)
        elif basic_module == "double_conv_vil":
            from xlstm_hved_torch.nn.vil import DoubleConvViL  # vil imports this module

            self.basic = DoubleConvViL(cin + skip_ch, features, order, mlstm_kernel)
        else:
            raise NotImplementedError(f"basic_module={basic_module!r} is not ported yet")

    def forward(self, encoder_features, x):
        x = resize_trilinear(x, encoder_features.shape[2:])
        if self.rsm:
            x = self.atten(x, encoder_features)
        else:
            x = torch.cat([encoder_features, x], dim=1)
        return self.basic(x)


def block_diag_conv(streams: int, cin: int, features: int, kernel_size: int = 3,
                    stride: int = 1) -> Conv3d:
    """M independent per-stream convs on the folded (B, M*cin, ...) layout:
    a grouped conv with groups = M."""
    return conv3d(streams * cin, streams * features, kernel_size, stride, streams)


class BlockDiagSingleConv(nn.Module):
    """SingleConv per stream on the folded layout."""

    def __init__(self, streams: int, cin: int, features: int, stride: int = 1,
                 order: str = "ilc"):
        super().__init__()
        _check_order(order)
        self.order = order
        self.conv = block_diag_conv(streams, cin, features, 3, stride)

    def forward(self, x):
        return _apply_order(self.order, self.conv, x)


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


class BlockDiagEncoderStage(nn.Module):
    """EncoderStage per stream on the folded layout."""

    def __init__(self, streams: int, cin: int, features: int, num_block: int = 1,
                 apply_pooling: bool = True, order: str = "ilc"):
        super().__init__()
        self.apply_pooling = apply_pooling
        self.num_block = num_block
        for i in range(num_block):
            self.add_module(f"block{i}", BlockDiagDoubleConv(
                streams, cin if i == 0 else features, features, True, order))

    def forward(self, x):
        if self.apply_pooling:
            x = max_pool3d(x)
        for i in range(self.num_block):
            x = getattr(self, f"block{i}")(x)
        return x
