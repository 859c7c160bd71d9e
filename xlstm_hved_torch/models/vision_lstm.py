"""Vision-LSTM classifiers and the hierarchical ViL patch encoder
(counterpart of `xlstm_hved_tpu/models/vision_lstm.py`).

ViT-style: a conv patch embedding, a learned position embedding on the
train-time grid (resampled to another grid by `interpolate_sincos`), ViL
blocks alternating their token direction, bilateral-average pooling and a
linear head; 2-D (`VisionLSTM`) and 3-D (`VisionLSTM3D`). `ViL3DPatchEncoder`
is a 4-stage pyramid of strided conv embeddings, each followed by ViL blocks,
returning every stage's map.

Inputs and the encoder's maps are channels-first, (B, C, *spatial); tokens
are (B, S, dim) in row-major grid order, and the position embedding keeps
the JAX layout (1, *grid, dim), so a converted JAX tree (`utils/convert.py`)
loads with `load_state_dict(strict=True)`. flax infers the input width and
grid from the first call; here they are arguments (`in_channels`,
`img_size`). `dtype` (None or torch.bfloat16) casts at the op as the JAX
modules' `dtype` does: the patch embeddings, the ViL projections and causal
convs, and the head; the gates, the mLSTM and the norms stay fp32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from xlstm_hved_torch.nn.blocks import Conv2d, Conv3d, Linear, set_compute_dtype
from xlstm_hved_torch.nn.vil import ResidualLayerNorm, ViLBlock


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 at |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of `jax.image.resize(method="cubic")`
    along one axis: the Keys kernel at half-pixel centres, widened by the
    shrink factor when the axis shrinks (antialiasing), each output's
    weights renormalised to sum to 1 (so the edges do not clamp), and zero
    for a sample outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps32 = float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_sincos(embed: torch.Tensor, seqlens: Sequence[int]) -> torch.Tensor:
    """Resample a grid-shaped position embedding (1, *grid, dim) to the grid
    `seqlens`: `jax.image.resize(..., method="cubic")`, separable, one
    weight matrix per axis whose length changes. (torch's bicubic mode is
    another function: a = -0.75, clamped edges, no antialiasing.)"""
    if embed.dim() - 2 != len(seqlens):
        raise ValueError(f"embed {tuple(embed.shape)} does not match grid {tuple(seqlens)}")
    out = embed
    for ax, n_out in enumerate(seqlens, start=1):
        n_in = out.shape[ax]
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out).to(device=out.device, dtype=out.dtype)
        out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
    return out


class VitPosEmbedND(nn.Module):
    """A learned position embedding `embed` (1, *seqlens, dim), added to
    (B, *grid, dim) tokens; resampled when their grid is another."""

    def __init__(self, dim: int, seqlens: Sequence[int]):
        super().__init__()
        self.embed = nn.Parameter(nn.init.trunc_normal_(torch.empty(1, *seqlens, dim), std=0.02))

    def forward(self, x):
        embed = self.embed
        if x.shape[1:] != embed.shape[1:]:
            embed = interpolate_sincos(embed, x.shape[1:-1])
        return x + embed.to(x.dtype)


class PatchEmbed(nn.Module):
    """A non-overlapping conv patch embedding ("proj") of a (B, C, *spatial)
    input: returns its (B, S, dim) tokens and the grid."""

    def __init__(self, dim: int, patch_size: int = 16, spatial_ndim: int = 2,
                 in_channels: int = 3):
        super().__init__()
        conv = Conv3d if spatial_ndim == 3 else Conv2d
        self.proj = conv(in_channels, dim, patch_size, patch_size)

    def forward(self, x) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        x = self.proj(x)
        return x.flatten(2).transpose(1, 2), tuple(x.shape[2:])


class VisionLSTMEncoder(nn.Module):
    """The position embedding, `depth` ViL blocks (the odd ones reversed) and
    a final norm. With `seqlens` the embedding is grid-shaped
    (`pos_embed_nd`, resampled to other grids); without, a flat `pos_embed`
    (1, num_tokens, dim)."""

    def __init__(self, dim: int = 192, depth: int = 12, chunk_size: int = 128,
                 seqlens: Optional[Sequence[int]] = None, num_tokens: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, mlstm_kernel: Optional[bool] = None):
        super().__init__()
        self.dim, self.depth = dim, depth
        self.seqlens = None if seqlens is None else tuple(seqlens)
        if self.seqlens is not None:
            self.pos_embed_nd = VitPosEmbedND(dim, self.seqlens)
        else:
            if num_tokens is None:
                raise ValueError("VisionLSTMEncoder needs seqlens or num_tokens")
            self.pos_embed = nn.Parameter(0.02 * torch.randn(1, num_tokens, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViLBlock(dim, chunk_size, mlstm_kernel,
                                                  reverse=i % 2 == 1, dtype=dtype))
        self.norm = ResidualLayerNorm(dim)

    def forward(self, tokens, grid: Optional[Sequence[int]] = None):
        B, S, _ = tokens.shape
        if self.seqlens is not None:
            g = tuple(grid) if grid is not None else self.seqlens
            x = self.pos_embed_nd(tokens.reshape(B, *g, self.dim)).reshape(B, S, self.dim)
        else:
            x = tokens + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x)


def bilateral_avg(x: torch.Tensor) -> torch.Tensor:
    """Mean of the first and the last token."""
    return 0.5 * (x[:, 0] + x[:, -1])


class VisionLSTM(nn.Module):
    """2-D image classifier: (B, in_channels, H, W) -> (B, num_classes).
    The position embedding lives on `pos_grid`, by default the grid of
    `img_size`; other input sizes resample it."""

    spatial_ndim = 2

    def __init__(self, dim: int = 192, depth: int = 12, num_classes: int = 1000,
                 patch_size: int = 16, chunk_size: int = 128,
                 pos_grid: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3,
                 img_size: Sequence[int] = (224, 224), mlstm_kernel: Optional[bool] = None):
        super().__init__()
        grid = tuple(pos_grid) if pos_grid else tuple(s // patch_size for s in img_size)
        self.patch_embed = PatchEmbed(dim, patch_size, self.spatial_ndim, in_channels)
        self.encoder = VisionLSTMEncoder(dim, depth, chunk_size, seqlens=grid, dtype=dtype,
                                         mlstm_kernel=mlstm_kernel)
        self.head = Linear(dim, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        tokens, grid = self.patch_embed(x)
        return self.head(bilateral_avg(self.encoder(tokens, grid=grid)))


class VisionLSTM3D(VisionLSTM):
    """3-D volume classifier: (B, in_channels, D, H, W) -> (B, num_classes)."""

    spatial_ndim = 3

    def __init__(self, dim: int = 192, depth: int = 12, num_classes: int = 2,
                 patch_size: int = 8, chunk_size: int = 128,
                 pos_grid: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 4,
                 img_size: Sequence[int] = (128, 128, 128),
                 mlstm_kernel: Optional[bool] = None):
        super().__init__(dim, depth, num_classes, patch_size, chunk_size, pos_grid, dtype,
                         in_channels, img_size, mlstm_kernel)


class ViL3DPatchEncoder(nn.Module):
    """4-stage hierarchical encoder: per stage a strided conv embedding
    (`embed{stage}`, stride 4 then 2) and `depths[stage]` ViL blocks (the odd
    ones reversed) over its voxels. (B, in_channels, D, H, W) -> the list of
    the stages' (B, dims[stage], ...) maps."""

    def __init__(self, dims: Sequence[int] = (32, 64, 128, 256),
                 depths: Sequence[int] = (2, 2, 2, 2), chunk_size: int = 128,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 4,
                 mlstm_kernel: Optional[bool] = None):
        super().__init__()
        self.dims, self.depths = tuple(dims), tuple(depths)
        cin = in_channels
        for stage, (dim, depth) in enumerate(zip(self.dims, self.depths)):
            stride = 4 if stage == 0 else 2
            self.add_module(f"embed{stage}", Conv3d(cin, dim, stride, stride))
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}",
                                ViLBlock(dim, chunk_size, mlstm_kernel, reverse=i % 2 == 1,
                                         dtype=dtype))
            cin = dim
        set_compute_dtype(self, dtype)

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for stage, depth in enumerate(self.depths):
            x = getattr(self, f"embed{stage}")(x)
            shape = x.shape
            tokens = x.flatten(2).transpose(1, 2)
            for i in range(depth):
                tokens = getattr(self, f"stage{stage}_block{i}")(tokens)
            x = tokens.transpose(1, 2).reshape(shape)
            feats.append(x)
        return feats
