"""Vision-xLSTM (ViL) token mixer (counterpart of `xlstm_hved_tpu/nn/vil.py`).

Submodule and parameter names follow the flax scopes, so a converted JAX
tree (`utils/convert.py`) loads with `load_state_dict(strict=True)`.
Initialisation follows the JAX package's xLSTM init (small_init, wang_init,
fgate bias linspace 3..6, zero gate kernels, zero norm offsets).

- LinearHeadwiseExpand: block-diagonal per-head projection
- CausalConv1d: depthwise causal conv over tokens, left pad k-1
- ResidualLayerNorm / MultiHeadLayerNorm: scale (1 + w), no bias
- MatrixLSTMCell: i/f gates (fp32) from concat(q, k, v), mLSTM, out-norm
- ViLLayer: up-proj -> (causal conv, headwise q/k/v, mLSTM) * SiLU(z) -> down,
  over the tokens reversed when `reverse` (Vision-LSTM's alternating
  directions)
- DropPath: per-sample stochastic depth on a residual branch
- ViLBlock: pre-LN residual ViLLayer

`dtype` follows the JAX modules' (the port's precision policy, cast at the op): None
computes the projections and the causal conv in the parameters' dtype;
torch.bfloat16 casts their input and weights to bf16 at the op, as flax's
`dtype=` does (the Vision-LSTM classifiers' `dtype`). The gates, the mLSTM
and the norms stay fp32 either way, as in JAX.
- ViLLayer3D: flattens a (B, C, D, H, W) volume to D*H*W tokens in
  row-major DHW order, runs one ViLBlock in fp32, reshapes back and returns
  the input's dtype: the fp32 island of bf16 compute, so the mLSTM (its
  CUDA kernels included) always receives fp32
- DoubleConvViL: DoubleConv (in the compute dtype), LeakyReLU(0.01),
  ViLLayer3D (the ViL decoder block of U_HVEDConvXLSTMNet3D)
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import DoubleConv, _cast, at_least_fp32
from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise
from xlstm_hved_torch.ops.mlstm_cuda import mlstm_forward
from xlstm_hved_torch.parallel.mesh import sample_rows


def _normal_(t: torch.Tensor, std: float) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std)


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise the last axis in at least fp32 (biased variance)."""
    x32 = at_least_fp32(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps)


class LinearHeadwiseExpand(nn.Module):
    """Block-diagonal projection with a (d, d) weight per head. The xLSTM
    init scales it with the OUTER embedding width `init_dim`."""

    def __init__(self, dim: int, num_heads: int, init_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        d = dim // num_heads
        std = math.sqrt(2.0 / (5.0 * init_dim))
        self.weight = nn.Parameter(_normal_(torch.empty(num_heads, d, d), std))

    def forward(self, x):
        xh = x.reshape(*x.shape[:-1], self.num_heads, -1)
        # JAX casts the weight to `dtype`, or else to x's dtype
        y = torch.einsum("...hd,hed->...he", _cast(xh, self.dtype),
                         self.weight.to(self.dtype or x.dtype))
        return y.reshape(x.shape)


class CausalConv1d(nn.Module):
    """Depthwise causal conv over the token axis of (B, S, F)."""

    def __init__(self, dim: int, kernel_size: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.conv = nn.Conv1d(dim, dim, kernel_size, groups=dim)

    def forward(self, x):
        xc = F.pad(_cast(x, self.dtype).transpose(1, 2), (self.kernel_size - 1, 0))
        conv = self.conv
        return conv._conv_forward(xc, _cast(conv.weight, self.dtype),
                                  _cast(conv.bias, self.dtype)).transpose(1, 2)


class ResidualLayerNorm(nn.Module):
    """LayerNorm over the last axis with scale (1 + w) and no bias."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return (_layer_norm(x, self.eps) * (1.0 + self.weight)).to(x.dtype)


class MultiHeadLayerNorm(nn.Module):
    """Per-head LayerNorm of (B, NH, S, DH) with a (1 + w) scale over the
    flattened NH*DH axis, no bias."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        _, NH, _, DH = x.shape
        y = _layer_norm(x, self.eps) * (1.0 + self.weight).reshape(1, NH, 1, DH)
        return y.to(x.dtype)


class MatrixLSTMCell(nn.Module):
    """q, k, v -> mLSTM -> per-head out-norm.

    `mlstm_kernel`: None runs the CUDA kernels on CUDA tensors (the forward
    kernel, and the states and backward kernels for the gradient) and the
    plain chunkwise scan, differentiated by autograd, on CPU tensors; False
    runs the plain scan anywhere; True always asks for the kernels (which
    raise on CPU tensors).
    """

    def __init__(self, dim: int, num_heads: int, chunk_size: int = 128,
                 mlstm_kernel: Optional[bool] = None):
        super().__init__()
        self.num_heads = num_heads
        self.chunk_size = chunk_size
        self.mlstm_kernel = mlstm_kernel
        self.igate = nn.Linear(3 * dim, num_heads)
        self.fgate = nn.Linear(3 * dim, num_heads)
        with torch.no_grad():
            self.igate.weight.zero_()
            self.igate.bias.normal_(0.0, 0.1)
            self.fgate.weight.zero_()
            self.fgate.bias.copy_(torch.linspace(3.0, 6.0, num_heads))
        self.outnorm = MultiHeadLayerNorm(dim)

    def forward(self, q, k, v):
        B, S, _ = q.shape
        NH = self.num_heads
        gate_in = torch.cat([q, k, v], dim=-1).to(self.igate.weight.dtype)
        igate = self.igate(gate_in).transpose(1, 2)  # (B, NH, S)
        fgate = self.fgate(gate_in).transpose(1, 2)

        def to_heads(t):
            return t.reshape(B, S, NH, -1).transpose(1, 2)

        use_kernel = (q.device.type == "cuda" if self.mlstm_kernel is None
                      else self.mlstm_kernel)
        mlstm = mlstm_forward if use_kernel else mlstm_chunkwise
        h = mlstm(to_heads(q), to_heads(k), to_heads(v), igate, fgate,
                  chunk_size=self.chunk_size)
        h = self.outnorm(h)
        return h.transpose(1, 2).reshape(B, S, -1)


class ViLLayer(nn.Module):
    """The mLSTM token mixer: inner width 2*dim, q/k/v in blocks of 4 (2 when
    dim is not a multiple of 4), which is also the mLSTM head count, and a
    causal conv of width 4; with `reverse` it runs over the tokens in
    reverse order and reverses its output back."""

    def __init__(self, dim: int, chunk_size: int = 128,
                 mlstm_kernel: Optional[bool] = None, reverse: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        qkv_block = 4 if dim % 4 == 0 else 2
        inner = 2 * dim
        num_proj_heads = inner // qkv_block
        self.reverse, self.dtype = reverse, dtype
        self.proj_up = nn.Linear(dim, 2 * inner, bias=False)
        _normal_(self.proj_up.weight, math.sqrt(2.0 / (5.0 * dim)))
        self.conv1d = CausalConv1d(inner, dtype=dtype)
        self.q_proj = LinearHeadwiseExpand(inner, num_proj_heads, dim, dtype)
        self.k_proj = LinearHeadwiseExpand(inner, num_proj_heads, dim, dtype)
        self.v_proj = LinearHeadwiseExpand(inner, num_proj_heads, dim, dtype)
        self.mlstm_cell = MatrixLSTMCell(inner, qkv_block, chunk_size, mlstm_kernel)
        self.learnable_skip = nn.Parameter(torch.ones(inner))
        self.proj_down = nn.Linear(inner, dim, bias=False)
        _normal_(self.proj_down.weight, 2.0 / math.sqrt(dim))

    def _dense(self, layer: nn.Linear, x):
        return F.linear(_cast(x, self.dtype), _cast(layer.weight, self.dtype))

    def forward(self, x):
        if self.reverse:
            x = x.flip(1)
        x_mlstm, z = self._dense(self.proj_up, x).chunk(2, dim=-1)
        x_conv_act = F.silu(self.conv1d(x_mlstm))
        q = self.q_proj(x_conv_act)
        k = self.k_proj(x_conv_act)
        v = self.v_proj(x_mlstm)
        h = self.mlstm_cell(q, k, v).to(x_conv_act.dtype)
        h = h + self.learnable_skip * x_conv_act
        y = self._dense(self.proj_down, h * F.silu(z))
        return y.flip(1) if self.reverse else y


class DropPath(nn.Module):
    """Per-sample stochastic depth: x + residual, with each sample's residual
    dropped with probability `rate` (the kept ones scaled by 1 / (1 - rate)
    when `scale_by_keep`). The draw comes from an explicit `generator`; with
    none (or rate 0) it is x + residual, as the JAX module is without a
    "droppath" RNG. Under a data mesh the draw is the global batch's
    (`sample_rows`). Parameter-free; every preset has rate 0."""

    def __init__(self, rate: float = 0.0, scale_by_keep: bool = True):
        super().__init__()
        self.rate, self.scale_by_keep = rate, scale_by_keep

    def forward(self, x, residual, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or generator is None:
            return x + residual
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = sample_rows(lambda s: torch.rand(s, generator=generator, device=generator.device),
                           shape) < keep
        if self.scale_by_keep:
            residual = residual / keep
        return x + residual * mask.to(device=x.device, dtype=residual.dtype)


class ViLBlock(nn.Module):
    """Pre-LN residual ViLLayer, with stochastic depth when `drop_path` > 0
    (drawn from the `generator` passed to forward)."""

    def __init__(self, dim: int, chunk_size: int = 128,
                 mlstm_kernel: Optional[bool] = None, drop_path: float = 0.0,
                 reverse: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = ResidualLayerNorm(dim)
        self.layer = ViLLayer(dim, chunk_size, mlstm_kernel, reverse, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.drop_path(x, self.layer(self.norm(x)), generator)


class ViLLayer3D(nn.Module):
    """One forward ViLBlock over the D*H*W tokens of a (B, C, D, H, W)
    volume, run in (at least) fp32 with autocast off."""

    def __init__(self, dim: int, chunk_size: int = 128,
                 mlstm_kernel: Optional[bool] = None):
        super().__init__()
        self.dim = dim
        self.vil = ViLBlock(dim, chunk_size, mlstm_kernel)

    def forward(self, x):
        b, c = x.shape[:2]
        if c != self.dim:
            raise ValueError(f"ViLLayer3D expects {self.dim} channels, got {c}")
        with torch.autocast(device_type=x.device.type, enabled=False):
            dtype = torch.promote_types(x.dtype, torch.float32)
            tokens = x.to(dtype).flatten(2).transpose(1, 2)  # (B, DHW, C)
            y = self.vil(tokens)
        return y.transpose(1, 2).reshape(x.shape).to(x.dtype)


class DoubleConvViL(nn.Module):
    """Decoder DoubleConv, LeakyReLU(0.01), then one ViLLayer3D over its
    `features` channels: dim 16 in U_HVEDConvXLSTMNet3D's seg decoder stage 0,
    so inner width 32, 4 heads of width 8, over (D/4)(H/4)(W/4) tokens.

    The JAX module builds its ViLLayer3D without the Pallas switch; here
    `mlstm_kernel` is passed down as the bottleneck ViL's is, so that
    `HVEDConfig.mlstm_kernel=False` puts both ViL sites on the plain scan."""

    def __init__(self, cin: int, features: int, order: str = "ilc",
                 mlstm_kernel: Optional[bool] = None, num_groups: int = 8):
        super().__init__()
        self.double_conv = DoubleConv(cin, features, False, order, num_groups=num_groups)
        self.vil = ViLLayer3D(features, mlstm_kernel=mlstm_kernel)

    def forward(self, x):
        return self.vil(F.leaky_relu(self.double_conv(x), negative_slope=0.01))
