"""3D deformable convolution by trilinear gather in NCDHW (counterpart of
`xlstm_hved_tpu/ops/deform.py`; no kernel of this repository runs here).

An offset conv predicts three offsets (z, y, x) per kernel tap; the input is
sampled at each output voxel's tap position plus its offset with trilinear
interpolation, and a 1x1 conv reduces the gathered taps. The gather is an
explicit one in at least fp32 with the JAX formula (clip, floor, the upper
corner min(i0 + 1, n - 1), the lerps in the same order), not
`F.grid_sample`: the offset conv is zero-initialised, so at init every
sample lies on the integer grid, where grid_sample's normalisation to
[-1, 1] can move a coordinate by an ulp and `floor` one voxel lower (the
offset gradient then becomes a backward difference, JAX's is a forward
one). The clip takes half the gradient at a bound, as `jnp.clip` does
(torch.clamp passes all of it; `torch.maximum` / `torch.minimum` split a tie
as JAX does), which at zero offsets is where the border voxels' taps sit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xlstm_hved_torch.nn.blocks import Conv3d, _same_padding, at_least_fp32


def _clip(v: torch.Tensor, hi: float) -> torch.Tensor:
    """clip(v, 0, hi) with jnp.clip's gradient: half at a bound."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_full((), hi))


def trilinear_sample(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample x (C, D, H, W), or (B, C, D, H, W), at the float voxel
    coordinates coords (..., 3), or (B, ..., 3), ordered (z, y, x), clamped
    to the border. Returns (C, ...), or (B, C, ...), in the dtype of x and
    coords promoted."""
    if x.dim() == 4:
        return trilinear_sample(x[None], coords[None])[0]
    B, C, D, H, W = x.shape
    points = coords.shape[1:-1]
    c = coords.reshape(B, -1, 3)
    cz, cy, cx = (_clip(c[..., i], n - 1.0) for i, n in enumerate((D, H, W)))
    z0, y0, x0 = torch.floor(cz), torch.floor(cy), torch.floor(cx)
    fz, fy, fx = ((v - v0)[:, None] for v, v0 in ((cz, z0), (cy, y0), (cx, x0)))
    z0, y0, x0 = z0.long(), y0.long(), x0.long()
    z1 = torch.clamp(z0 + 1, max=D - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    flat = x.reshape(B, C, D * H * W)

    def g(zi, yi, xi):
        idx = (zi * H + yi) * W + xi
        return torch.gather(flat, 2, idx[:, None].expand(B, C, idx.shape[1]))

    c00 = g(z0, y0, x0) * (1 - fx) + g(z0, y0, x1) * fx
    c01 = g(z0, y1, x0) * (1 - fx) + g(z0, y1, x1) * fx
    c10 = g(z1, y0, x0) * (1 - fx) + g(z1, y0, x1) * fx
    c11 = g(z1, y1, x0) * (1 - fx) + g(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return (c0 * (1 - fz) + c1 * fz).reshape(B, C, *points)


def _offset_conv(cin: int, kernel_size: int, stride: int) -> Conv3d:
    """3 offsets per tap; zero-initialised, as the JAX module's."""
    conv = Conv3d(cin, 3 * kernel_size ** 3, kernel_size, stride)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def _same_pad(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """flax "SAME" padding (the extra voxel high), for the offset conv."""
    return F.pad(x, [p for n in reversed(x.shape[2:])
                     for p in _same_padding(n, kernel_size, stride)])


def deform_gather(x: torch.Tensor, offsets: torch.Tensor, kernel_size: int,
                  stride: int) -> torch.Tensor:
    """x (B, C, D, H, W) sampled at every output voxel's taps moved by
    `offsets` (B, taps * 3, D', H', W'), read tap-major with (z, y, x) last.
    Returns the tap-major stack (B, taps * C, D', H', W') in at least fp32,
    channel tap * C + c, the order the JAX module's `proj` kernel reads."""
    B, C = x.shape[:2]
    ks, out_sp = kernel_size, offsets.shape[2:]
    taps = ks ** 3
    dt = at_least_fp32(offsets).dtype
    axes = [torch.arange(n, device=x.device, dtype=dt) * stride for n in out_sp]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))            # (3, D', H', W')
    half = torch.arange(ks, device=x.device, dtype=dt) - (ks - 1) // 2
    tap = torch.stack(torch.meshgrid(half, half, half, indexing="ij"), -1).reshape(taps, 3)
    offs = at_least_fp32(offsets).reshape(B, taps, 3, *out_sp)
    coords = (grid[None, None] + tap[None, :, :, None, None, None]) + offs
    gathered = trilinear_sample(at_least_fp32(x), coords.movedim(2, -1))  # (B, C, taps, ...)
    return gathered.transpose(1, 2).reshape(B, taps * C, *out_sp)


class DeformConv3d(nn.Module):
    """Deformable 3D conv: `offset_conv` (3 * k^3 channels, stride `stride`,
    flax "SAME" padding, zero-initialised), the trilinear gather, and the
    1x1 `proj` over the tap-major stack in the compute dtype."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.offset_conv = _offset_conv(cin, kernel_size, stride)
        self.proj = Conv3d(kernel_size ** 3 * cin, features, 1, bias=use_bias)

    def forward(self, x):
        offsets = self.offset_conv(_same_pad(x, self.kernel_size, self.stride))
        gathered = deform_gather(x, offsets, self.kernel_size, self.stride)
        return self.proj(gathered.to(x.dtype))


class AttDeformConv3d(nn.Module):
    """Attention-gated deformable conv: a 1x1 `conv_se` shrinks the channels
    by `se_ratio`, the offsets predicted from it are gated by a spatial
    attention map of the offset field (`att`), then the gather and the 1x1
    `proj` run on the reduced features."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 se_ratio: int = 4, use_bias: bool = False):
        from xlstm_hved_torch.nn.skr import SpatialAttention3D  # skr imports this module

        super().__init__()
        se_ch = max(cin // se_ratio, 1)
        self.kernel_size, self.stride = kernel_size, stride
        self.conv_se = Conv3d(cin, se_ch, 1, bias=use_bias)
        self.offset_conv = _offset_conv(se_ch, kernel_size, stride)
        self.att = SpatialAttention3D()
        self.proj = Conv3d(kernel_size ** 3 * se_ch, features, 1, bias=use_bias)

    def forward(self, x):
        x = self.conv_se(x)
        offsets = self.offset_conv(_same_pad(x, self.kernel_size, self.stride))
        offsets = offsets * self.att(offsets)
        gathered = deform_gather(x, offsets, self.kernel_size, self.stride)
        return self.proj(gathered.to(x.dtype))
