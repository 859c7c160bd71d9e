"""Plain PyTorch reference of UXlstmEnc 3-D, the xLSTM-UNet of Chen et al.
(arXiv:2407.01530; upstream `UxLSTMEnc_3d.py:90-554`), and of the
deep-supervised SGD step of nnU-Net v2's trainer, written for reading
rather than speed. It imports nothing of the program; its parameter names
are those of the program's module tree, so one state dict made by the
benchmark loads into both.

The net (`UXlstmEnc3d`, from the configuration's plan): a stem at full
resolution (a residual block with a 1x1 skip, then the stage-0 extra
blocks); per encoder stage a strided residual block, its extra blocks and a
mixer (a residual block on stages 0-2, a ViL block from stage 3 on, over
the map's channels when it has no more voxels than channels); per decoder
stage nearest upsampling by the stage's pool, a 1x1 conv, the skip joined,
a residual block with a 1x1 skip and its extra blocks, and a 1x1 head. A
residual block is conv-norm-LeakyReLU, conv-norm, plus the input (through a
strided 1x1 conv when the width or the stride changes), LeakyReLU(1e-2);
every conv pads k // 2, the norm is an affine instance norm (eps 1e-5). The
deep stages keep one block (nnU-Net's UxLSTM trainers cap them). The ViL
block is pre-LayerNorm residual: up-projection to twice the inner width, a
causal depthwise conv of width 4 and SiLU, headwise q / k (v from the
unconvolved branch), four mLSTM heads (`reference/mlstm.py`, the quadratic
form), a per-head LayerNorm, a learnable skip, a SiLU gate, the
down-projection.

The step (`Step`): nnU-Net's `DC_and_BCE_loss` (BCE with logits plus the
soft dice of `MemoryEfficientSoftDiceLoss`, smooth 1e-5, per sample and
region) on each head against the targets at its scale, weighted 1 / 2^i,
the lowest head 0, normalised; the gradient norm clipped at `grad_clip`;
per parameter with a gradient d = g + wd * p, buf = d (first step) or mu *
buf + d, p -= lr * (d + mu * buf) (Nesterov), at the poly rate.

Everything computes in fp32. A model's `quant` (`reference/precision.py`)
rounds the input, the weight and the output of every conv outside the ViL,
the layers the configuration computes in bfloat16; the ViL's own (the fp32
island) rounds the operands and results of its projections, conv and mLSTM;
None leaves them in fp32.

Departures from the published description:
- the mLSTM's normaliser floor exp(-m) is taken at m >= -60, as the
  program's kernels do (upstream's `parallel_stabilized_simple` is not
  clamped);
- upstream resamples with F.interpolate(mode="nearest"); every pool is 2 or
  1, so upsampling repeats each voxel, and the targets are picked by
  strides (index i * f + f // 2 along an axis of factor f), which is what
  nnU-Net's nearest-exact resampling picks.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.mlstm import mlstm_quadratic

SMOOTH = 1e-5


def _same(t):
    return t


def leaky(x):
    return F.leaky_relu(x, 0.01)


def layer_norm(x, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class Param(nn.Module):
    """A bare `weight` under a module name."""

    def __init__(self, *shape):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*shape))


class QConv(nn.Conv3d):
    """Conv3d with padding k // 2 whose input, weight and output pass `quant`."""

    quant = None

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride, k // 2)

    def forward(self, x):
        q = self.quant or _same
        return q(F.conv3d(q(x), q(self.weight), self.bias, self.stride, self.padding))


class Norm(nn.Module):
    """Affine instance norm over the spatial axes."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean(dim=(2, 3, 4), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3, 4), keepdim=True)
        shape = (1, -1, 1, 1, 1)
        return ((x - mean) / torch.sqrt(var + 1e-5) * self.weight.view(shape)
                + self.bias.view(shape))


class ResBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, skip_conv=False):
        super().__init__()
        self.conv1, self.norm1 = QConv(cin, cout, 3, stride), Norm(cout)
        self.conv2, self.norm2 = QConv(cout, cout, 3), Norm(cout)
        self.conv3 = (QConv(cin, cout, 1, stride) if skip_conv or cin != cout or stride != 1
                      else None)

    def forward(self, x):
        y = self.norm2(self.conv2(leaky(self.norm1(self.conv1(x)))))
        return leaky(y + (x if self.conv3 is None else self.conv3(x)))


class MLSTMCell(nn.Module):
    quant = None

    def __init__(self, inner, heads=4):
        super().__init__()
        self.heads = heads
        self.igate = nn.Linear(3 * inner, heads)
        self.fgate = nn.Linear(3 * inner, heads)
        with torch.no_grad():  # construction values: the program's init
            self.igate.bias.zero_()
            self.fgate.bias.copy_(torch.linspace(3.0, 6.0, heads))
        self.outnorm = Param(inner)

    def forward(self, q, k, v):
        B, S, inner = q.shape
        NH = self.heads
        r = self.quant or _same
        g = r(torch.cat([q, k, v], dim=-1))
        ig = r(F.linear(g, r(self.igate.weight), self.igate.bias)).transpose(1, 2)
        fg = r(F.linear(g, r(self.fgate.weight), self.fgate.bias)).transpose(1, 2)

        def heads(t):
            return r(t).reshape(B, S, NH, -1).transpose(1, 2)

        h = layer_norm(r(mlstm_quadratic(heads(q), heads(k), heads(v), ig, fg)))
        h = h * (1.0 + self.outnorm.weight).reshape(1, NH, 1, -1)
        return h.transpose(1, 2).reshape(B, S, inner)


class Conv1dHolder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv1d(c, c, 4, groups=c)


class ViLLayer(nn.Module):
    quant = None

    def __init__(self, dim):
        super().__init__()
        inner = 2 * dim
        self.inner = inner
        self.proj_up = Param(2 * inner, dim)
        self.conv1d = Conv1dHolder(inner)
        self.q_proj, self.k_proj, self.v_proj = (Param(inner // 4, 4, 4) for _ in range(3))
        self.mlstm_cell = MLSTMCell(inner)
        self.learnable_skip = nn.Parameter(torch.ones(inner))
        self.proj_down = Param(dim, inner)

    def headwise(self, proj, x):
        r = self.quant or _same
        xh = r(x).reshape(*x.shape[:-1], proj.weight.shape[0], -1)
        return r(torch.einsum("...hd,hed->...he", xh, r(proj.weight)).reshape(x.shape))

    def forward(self, x):
        r = self.quant or _same
        up = r(F.linear(r(x), r(self.proj_up.weight)))
        xm, z = up[..., :self.inner], up[..., self.inner:]
        c = self.conv1d.conv
        xc = r(F.conv1d(F.pad(xm.transpose(1, 2), (3, 0)), r(c.weight), c.bias,
                        groups=self.inner)).transpose(1, 2)
        xc = F.silu(xc)
        h = self.mlstm_cell(self.headwise(self.q_proj, xc), self.headwise(self.k_proj, xc),
                            self.headwise(self.v_proj, xm))
        h = h + self.learnable_skip * xc
        return r(F.linear(r(h * F.silu(z)), r(self.proj_down.weight)))


class ViLBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = Param(dim)
        self.layer = ViLLayer(dim)

    def forward(self, x):
        return x + self.layer(layer_norm(x) * (1.0 + self.norm.weight))


class ViLMixer(nn.Module):
    """A ViL block over a map's voxels (patch tokens) or its channels
    (channel tokens, the voxels their features)."""

    def __init__(self, dim, channel_token):
        super().__init__()
        self.channel_token = channel_token
        self.vil = ViLBlock(dim)

    def forward(self, x):
        flat = x.flatten(2)
        y = self.vil(flat) if self.channel_token else self.vil(flat.transpose(1, 2)).transpose(1, 2)
        return y.reshape(x.shape)


def plan_shape(plan: dict):
    """(features, pools, encoder blocks, decoder blocks, map sizes) of a plan."""
    n = len(plan["conv_kernel_sizes"])
    base, cap = plan["UNet_base_num_features"], plan["unet_max_num_features"]
    feats = [min(base * 2 ** i, cap) for i in range(n)]
    pools = [tuple(p) for p in plan["pool_op_kernel_sizes"]]
    enc = list(plan["n_conv_per_stage_encoder"])
    dec = list(plan["n_conv_per_stage_decoder"])
    for s in range(math.ceil(n / 2), n):
        enc[s] = 1
    for s in range(math.ceil((n - 1) / 2 + 0.5), n - 1):
        dec[s] = 1
    sizes, size = [], list(plan["patch_size"])
    for p in pools:
        size = [a // b for a, b in zip(size, p)]
        sizes.append(tuple(size))
    return feats, pools, enc, dec, sizes


class Encoder(nn.Module):
    def __init__(self, plan, cin):
        super().__init__()
        feats, pools, blocks, _, sizes = plan_shape(plan)
        self.n, self.blocks = len(feats), blocks
        self.stem_res = ResBlock(cin, feats[0], skip_conv=True)
        for b in range(blocks[0] - 1):
            self.add_module(f"stem_block{b}", ResBlock(feats[0], feats[0]))
        c = feats[0]
        for s, f in enumerate(feats):
            self.add_module(f"stage{s}_res", ResBlock(c, f, max(pools[s]), skip_conv=True))
            for b in range(blocks[s] - 1):
                self.add_module(f"stage{s}_block{b}", ResBlock(f, f))
            voxels = math.prod(sizes[s])
            self.add_module(f"mixer{s}", ResBlock(f, f) if s < 3 else
                            ViLMixer(voxels if voxels <= f else f, voxels <= f))
            c = f

    def forward(self, x):
        x = self.stem_res(x)
        for b in range(self.blocks[0] - 1):
            x = getattr(self, f"stem_block{b}")(x)
        skips = []
        for s in range(self.n):
            x = getattr(self, f"stage{s}_res")(x)
            for b in range(self.blocks[s] - 1):
                x = getattr(self, f"stage{s}_block{b}")(x)
            x = getattr(self, f"mixer{s}")(x)
            skips.append(x)
        return skips


class Decoder(nn.Module):
    def __init__(self, plan, classes):
        super().__init__()
        feats, pools, _, blocks, _ = plan_shape(plan)
        self.n, self.pools, self.blocks = len(feats), pools, blocks
        for s in range(1, self.n):
            f = feats[-(s + 1)]
            self.add_module(f"up{s}_conv", QConv(feats[-s], f, 1))
            self.add_module(f"dec{s}_res", ResBlock(2 * f, f, skip_conv=True))
            for b in range(blocks[s - 1] - 1):
                self.add_module(f"dec{s}_block{b}", ResBlock(f, f))
            self.add_module(f"seg{s}", QConv(f, classes, 1))

    def forward(self, skips):
        x, heads = skips[-1], []
        for s in range(1, self.n):
            for axis, r in enumerate(self.pools[-s]):
                x = x.repeat_interleave(r, dim=axis + 2)
            x = torch.cat([getattr(self, f"up{s}_conv")(x), skips[-(s + 1)]], dim=1)
            x = getattr(self, f"dec{s}_res")(x)
            for b in range(self.blocks[s - 1] - 1):
                x = getattr(self, f"dec{s}_block{b}")(x)
            heads.append(getattr(self, f"seg{s}")(x))
        return heads[::-1]


class UXlstmEnc3d(nn.Module):
    def __init__(self, plan: dict, cin: int, classes: int):
        super().__init__()
        self.encoder = Encoder(plan, cin)
        self.decoder = Decoder(plan, classes)

    def forward(self, x):
        return self.decoder(self.encoder(x))


def set_quant(module: nn.Module, quant, vil_quant=None) -> nn.Module:
    """`quant` on every conv outside the ViL, `vil_quant` on the ViL's own
    products (None: fp32)."""
    for m in module.modules():
        if isinstance(m, QConv):
            m.quant = quant
        elif isinstance(m, (ViLLayer, MLSTMCell)):
            m.quant = vil_quant
    return module


# ------------------------------------------------------------ the step


def ds_scales(pools):
    out, acc = [], [1] * len(pools[0])
    for p in pools:
        acc = [a * b for a, b in zip(acc, p)]
        out.append(tuple(1.0 / a for a in acc))
    return out[:-1]


def ds_weights(n):
    w = [0.5 ** i for i in range(n - 1)] + [0.0]
    return [v / sum(w) for v in w]


def ds_targets(regions, scales):
    out = []
    for s in scales:
        picks = tuple(slice(round(1 / v) // 2, None, round(1 / v)) for v in s)
        out.append(regions[(slice(None), slice(None)) + picks])
    return out


def dc_bce(logits, target):
    p = torch.sigmoid(logits)
    bce = (torch.clamp(logits, min=0) - logits * target
           + torch.log1p(torch.exp(-logits.abs()))).mean()
    axes = (2, 3, 4)
    dice = (2 * (p * target).sum(axes) + SMOOTH) / (p.sum(axes) + target.sum(axes) + SMOOTH)
    return bce - dice.mean()


def ds_loss(heads: Sequence[torch.Tensor], targets: Sequence[torch.Tensor]):
    return sum(w * dc_bce(h, t) for h, t, w in zip(heads, targets, ds_weights(len(heads)))
               if w != 0.0)


class Step:
    """nnU-Net's training step on the reference net: the deep-supervised
    loss, its gradient (None for a parameter the loss does not reach, which
    then does not move), the gradients' norm clipped, Nesterov SGD with L2
    weight decay at lr0 * (1 - (step // steps_per_epoch) / epochs)^power.
    `grad1`: each leaf's gradient norm in the first step (0 without one)."""

    def __init__(self, net, train: Dict[str, float]):
        self.net = net
        self.names, self.params = zip(*net.named_parameters())
        self.t = train
        self.buf: List[torch.Tensor] = [None] * len(self.params)
        self.count = 0
        self.grad1: Dict[str, float] = {}

    def __call__(self, x, targets) -> float:
        t = self.t
        loss = ds_loss(self.net(x), targets)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        if self.count == 0:
            self.grad1 = {n: 0.0 if g is None else float(g.double().norm())
                          for n, g in zip(self.names, grads)}
        total = torch.sqrt(sum(g.double().square().sum() for g in grads if g is not None))
        coef = torch.clamp(t["grad_clip"] / (total + 1e-6), max=1.0).float()
        epoch = self.count // t["steps_per_epoch"]
        lr = t["learning_rate"] * (1 - epoch / t["num_epochs"]) ** t["poly_power"]
        mu, wd = t["momentum"], t["weight_decay"]
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(self.params, grads)):
                if g is None:
                    continue
                d = g * coef + wd * p
                self.buf[i] = d.clone() if self.buf[i] is None else mu * self.buf[i] + d
                p -= lr * (d + mu * self.buf[i])
        self.count += 1
        return float(loss.detach())
