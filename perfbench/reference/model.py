"""Plain PyTorch reference of the benchmark's HVED configurations and of the
PatchGAN discriminator, in NCDHW, written for reading rather than speed.

It covers the arms the configurations under `perfbench/configs/` set: four
modality streams, each with its own encoder (grouped convs stand for the
per-stream weights), a Gaussian expert per stream and level fused with the
N(0, 1) prior by a product of experts over the kept streams, the VU block
that upsamples the latent into the decoder skip; the skip-return gate chain,
the bottleneck ViL, DuSE between the seg and recon decoders (the flagship);
the ViL in seg decoder stage 0 (the ViL-decoder preset). Parameter and
buffer names are those of the module tree of the program under test, so one
state dict made by the benchmark loads into both.

Everything computes in fp32, the ViL's mLSTM by the plain chunked sum of
`reference/mlstm.py`. A model's `quant` (see `reference/precision.py`)
rounds the input, the weight and the output of every conv and dense layer
outside the ViL, the layers the configurations compute in bfloat16, as the
program rounds them to its compute dtype; the ViL's own (the fp32 island
of the configurations) rounds the operands and results of its projections,
conv and mLSTM; None leaves them in fp32.
Layer order "ilc" (InstanceNorm, LeakyReLU 0.01, conv) is the only one the
configurations use.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.mlstm import mlstm_chunked

DUSE_LEVELS = 3
LOGVAR_CLIP = 50.0
POE_EPS = 1e-8


class QConv3d(nn.Conv3d):
    """Conv3d with padding k // 2 whose input and weight pass `quant`."""

    quant = None

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=True, padding=None):
        super().__init__(cin, cout, k, stride, k // 2 if padding is None else padding,
                         groups=groups, bias=bias)

    def forward(self, x):
        q = self.quant or (lambda t: t)
        return q(F.conv3d(q(x), q(self.weight), self.bias, self.stride, self.padding,
                          groups=self.groups))


class QLinear(nn.Linear):
    quant = None

    def forward(self, x):
        q = self.quant or (lambda t: t)
        return q(F.linear(q(x), q(self.weight), self.bias))


def set_quant(module: nn.Module, quant, vil_quant=None) -> nn.Module:
    """`quant` on every conv and dense layer outside the ViL, `vil_quant` on
    the ViL's own products (None: fp32)."""
    for m in module.modules():
        if isinstance(m, (QConv3d, QLinear)):
            m.quant = quant
        elif isinstance(m, (ViLLayer, MLSTMCell)):
            m.quant = vil_quant
    return module


def instance_norm(x, eps=1e-5):
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def leaky(x, slope=0.01):
    return F.leaky_relu(x, slope)


def channel_pool(x):
    return torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)


def upsample(x, size):
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="trilinear", align_corners=False)


class BatchNorm(nn.BatchNorm3d):
    """Train mode: normalise by the batch mean and biased variance and move
    the running statistics 1 % towards them. Eval mode: the running ones."""

    def __init__(self, c):
        super().__init__(c, eps=1e-5, momentum=0.01)

    def forward(self, x):
        shape = (1, -1, 1, 1, 1)
        if self.training:
            dims = (0, 2, 3, 4)
            mean = x.mean(dim=dims)
            var = (x - mean.view(shape)).square().mean(dim=dims)
            with torch.no_grad():
                self.running_mean.mul_(0.99).add_(0.01 * mean)
                self.running_var.mul_(0.99).add_(0.01 * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)


class OrderConv(nn.Module):
    """InstanceNorm, LeakyReLU, then the conv registered as `conv_name`."""

    def __init__(self, conv_name, conv):
        super().__init__()
        self.conv_name = conv_name
        self.add_module(conv_name, conv)

    def forward(self, x):
        return getattr(self, self.conv_name)(leaky(instance_norm(x)))


def single_conv(cin, cout, stride=1, groups=1):
    return OrderConv("Conv3DFast_0", QConv3d(cin, cout, 3, stride, groups))


def stream_conv(cin, cout, stride=1, streams=4):
    return OrderConv("conv", QConv3d(cin, cout, 3, stride, streams))


class Double(nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        self.conv1, self.conv2 = c1, c2

    def forward(self, x):
        return self.conv2(self.conv1(x))


def double_conv(cin, features, encoder):
    mid = max(features // 2, cin) if encoder else features
    return Double(single_conv(cin, mid), single_conv(mid, features))


class StreamEncoder(nn.Module):
    """Per-stream encoder level on the folded (B, M*C, ...) layout."""

    def __init__(self, streams, cin, features, pool):
        super().__init__()
        self.pool = pool
        mid = max(features // 2, cin)
        self.block0 = Double(stream_conv(streams * cin, streams * mid, 1, streams),
                             stream_conv(streams * mid, streams * features, 1, streams))

    def forward(self, x):
        return self.block0(F.max_pool3d(x, 2) if self.pool else x)


class Encoder(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.block0 = double_conv(cin, features, True)

    def forward(self, x):
        return self.block0(F.max_pool3d(x, 2))


class BasicConv(nn.Module):
    """Bias-free conv, InstanceNorm, LeakyReLU."""

    def __init__(self, cin, cout, k, groups=1):
        super().__init__()
        self.conv = QConv3d(cin, cout, k, groups=groups, bias=False)

    def forward(self, x):
        return leaky(instance_norm(self.conv(x)))


class DWConvNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dwconv = QConv3d(c, c, 3, groups=c, bias=False)
        self.pwconv = QConv3d(c, c, 1)
        self.BatchNorm_0 = BatchNorm(c)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.pwconv(self.dwconv(x))))


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1, self.conv2 = DWConvNorm(c), DWConvNorm(c)

    def forward(self, x):
        return F.relu(self.conv2(self.conv1(x)) + x)


class SpatialAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = QConv3d(2, 1, 1, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.conv(channel_pool(x)))


class SkrGate(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.res, self.sa = ResBlock(c), SpatialAttention()

    def forward(self, x):
        return self.sa(self.res(x))


class AttenJoin(nn.Module):
    """The seg decoder's join: the upsampled seg features self-gated by
    (1 + sigmoid) of their channel pool, the encoder skip gated by a sigmoid
    of both pools; each gate a grouped 7^3 conv (4 maps per pooled channel)
    followed by a 1x1 conv."""

    def __init__(self):
        super().__init__()
        self.enc_spatial = QConv3d(4, 16, 7, groups=4)
        self.enc_spatial2 = QConv3d(16, 1, 1)
        self.seg_spatial = QConv3d(2, 8, 7, groups=2)
        self.seg_spatial2 = QConv3d(8, 1, 1)

    def forward(self, seg_x, enc_x):
        seg_pool = channel_pool(seg_x)
        both = torch.cat([seg_pool, channel_pool(enc_x)], dim=1)
        enc_gate = torch.sigmoid(self.enc_spatial2(self.enc_spatial(both)))
        seg_gate = torch.sigmoid(self.seg_spatial2(self.seg_spatial(seg_pool)))
        return torch.cat([seg_x * (1.0 + seg_gate), enc_x + enc_x * enc_gate], dim=1)


class Decoder(nn.Module):
    """Upsample to the skip, join (AttenJoin, or a concat), then `basic`."""

    def __init__(self, basic, atten=False):
        super().__init__()
        if atten:
            self.atten = AttenJoin()
        self.basic = basic

    def forward(self, skip, x):
        x = upsample(x, skip.shape[2:])
        x = self.atten(x, skip) if hasattr(self, "atten") else torch.cat([skip, x], dim=1)
        return self.basic(x)


class DuSE(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc_comb = QLinear(2 * c, c)
        self.fc_ch1, self.fc_ch2 = QLinear(c, c), QLinear(c, c)
        self.conv_squeeze_ch1, self.conv_squeeze_ch2 = QConv3d(c, 1, 1), QConv3d(c, 1, 1)
        self.conv_comb = QConv3d(2, 1, 1)
        self.conv_adjust_ch1, self.conv_adjust_ch2 = QConv3d(1, 1, 3), QConv3d(1, 1, 3)
        self.bn_fuse_ch1, self.bn_fuse_ch2 = BatchNorm(c), BatchNorm(c)

    def forward(self, x1, x2):
        dims = (2, 3, 4)
        comb = self.fc_comb(torch.cat([x1.mean(dim=dims), x2.mean(dim=dims)], dim=-1))
        g1 = torch.sigmoid(self.fc_ch1(comb))[:, :, None, None, None]
        g2 = torch.sigmoid(self.fc_ch2(comb))[:, :, None, None, None]
        fused = self.conv_comb(torch.cat([self.conv_squeeze_ch1(x1),
                                          self.conv_squeeze_ch2(x2)], dim=1))
        a1 = torch.sigmoid(self.conv_adjust_ch1(fused))
        a2 = torch.sigmoid(self.conv_adjust_ch2(fused))
        return (self.bn_fuse_ch1(x1 + x1 * g1 + x1 * a1),
                self.bn_fuse_ch2(x2 + x2 * g2 + x2 * a2))


# ---------------------------------------------------------------- the ViL


def layer_norm(x, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class Weight(nn.Module):
    """A bare `weight` parameter under a module name."""

    def __init__(self, *shape):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*shape))


class Conv1dHolder(nn.Module):
    def __init__(self, c, k=4):
        super().__init__()
        self.conv = nn.Conv1d(c, c, k, groups=c)


def _same(t):
    return t


class MLSTMCell(nn.Module):
    quant = None

    def __init__(self, inner, heads, chunk):
        super().__init__()
        self.heads, self.chunk = heads, chunk
        self.igate = nn.Linear(3 * inner, heads)
        self.fgate = nn.Linear(3 * inner, heads)
        self.outnorm = Weight(inner)

    def forward(self, q, k, v):
        B, S, inner = q.shape
        NH = self.heads
        r = self.quant or _same
        g = r(torch.cat([q, k, v], dim=-1))
        ig = r(F.linear(g, r(self.igate.weight), self.igate.bias)).transpose(1, 2)
        fg = r(F.linear(g, r(self.fgate.weight), self.fgate.bias)).transpose(1, 2)

        def heads(t):
            return r(t).reshape(B, S, NH, -1).transpose(1, 2)

        h = r(mlstm_chunked(heads(q), heads(k), heads(v), ig, fg, self.chunk))
        h = layer_norm(h) * (1.0 + self.outnorm.weight).reshape(1, NH, 1, -1)
        return h.transpose(1, 2).reshape(B, S, inner)


class ViLLayer(nn.Module):
    """Up-projection to 2 x inner; the mLSTM branch (causal depthwise conv of
    width 4, SiLU, headwise q / k, v from the unconvolved branch, 4 heads)
    plus a learnable skip, gated by SiLU(z); down-projection. Its `quant`
    rounds the operands and results of its projections and conv."""

    quant = None

    def __init__(self, dim, chunk):
        super().__init__()
        inner = 2 * dim
        self.inner = inner
        self.proj_up = Weight(2 * inner, dim)
        self.conv1d = Conv1dHolder(inner)
        self.q_proj, self.k_proj, self.v_proj = (Weight(inner // 4, 4, 4) for _ in range(3))
        self.mlstm_cell = MLSTMCell(inner, 4, chunk)
        self.learnable_skip = nn.Parameter(torch.ones(inner))
        self.proj_down = Weight(dim, inner)

    def headwise(self, proj, x):
        r = self.quant or _same
        xh = r(x).reshape(*x.shape[:-1], proj.weight.shape[0], -1)
        return r(torch.einsum("...hd,hed->...he", xh, r(proj.weight)).reshape(x.shape))

    def forward(self, x):
        r = self.quant or _same
        up = r(F.linear(r(x), r(self.proj_up.weight)))
        xm, z = up[..., :self.inner], up[..., self.inner:]
        conv = self.conv1d.conv
        xc = r(F.conv1d(F.pad(xm.transpose(1, 2), (conv.kernel_size[0] - 1, 0)),
                        r(conv.weight), conv.bias, groups=self.inner)).transpose(1, 2)
        xc = F.silu(xc)
        h = self.mlstm_cell(self.headwise(self.q_proj, xc), self.headwise(self.k_proj, xc),
                            self.headwise(self.v_proj, xm))
        h = h + self.learnable_skip * xc
        return r(F.linear(r(h * F.silu(z)), r(self.proj_down.weight)))


class ViLBlock(nn.Module):
    def __init__(self, dim, chunk):
        super().__init__()
        self.norm = Weight(dim)
        self.layer = ViLLayer(dim, chunk)

    def forward(self, x):
        return x + self.layer(layer_norm(x) * (1.0 + self.norm.weight))


class ViL3D(nn.Module):
    """One ViL block over the D*H*W tokens of a volume, row-major."""

    def __init__(self, dim, chunk):
        super().__init__()
        self.vil = ViLBlock(dim, chunk)

    def forward(self, x):
        tokens = x.flatten(2).transpose(1, 2)
        return self.vil(tokens).transpose(1, 2).reshape(x.shape)


class DoubleConvViL(nn.Module):
    def __init__(self, cin, features, chunk):
        super().__init__()
        self.double_conv = double_conv(cin, features, False)
        self.vil = ViL3D(features, chunk)

    def forward(self, x):
        return self.vil(leaky(self.double_conv(x)))


# ------------------------------------------------------ experts and latents


def stack_prior(mu, logvar):
    zero = torch.zeros_like(mu[:, :1])
    return (torch.cat([zero, mu], dim=1),
            torch.cat([zero, torch.clamp(logvar, -LOGVAR_CLIP, LOGVAR_CLIP)], dim=1))


def product_of_experts(mu, logvar, keep):
    """Experts (B, 5, ...) with the prior at 0; keep (4,) bool."""
    k = torch.cat([torch.ones(1, dtype=torch.bool, device=mu.device), keep.to(mu.device)])
    k = k.to(mu.dtype).reshape(1, -1, *([1] * (mu.ndim - 2)))
    precision = k / (torch.exp(logvar) + POE_EPS)
    total = precision.sum(dim=1)
    return (mu * precision).sum(dim=1) / total, -torch.log(total)


class Output(NamedTuple):
    seg: torch.Tensor
    mu: Tuple[torch.Tensor, ...]
    logvar: Tuple[torch.Tensor, ...]
    recon: torch.Tensor


SUPPORTED = {"multi_stream": 4, "in_channels": 1, "out_channels": 3, "layer_order": "ilc",
             "fusion_level": 4, "basic_module": "double_conv", "mvae": True,
             "mvae_reduction": True, "shared_recon": True, "recon_skip": True,
             "final_sigmoid": True, "num_block": [1, 1, 1, 1], "fusion": False,
             "recon_decoder": True}


class HVED(nn.Module):
    """The HVED network of a configuration dict (the keys of
    `perfbench/configs/*.json`'s "model")."""

    def __init__(self, cfg: dict):
        super().__init__()
        for key, value in SUPPORTED.items():
            if cfg.get(key, value) != value:
                raise NotImplementedError(f"the reference has no arm {key}={cfg[key]!r}")
        f, levels, M = cfg["f_maps"], cfg["num_levels"], SUPPORTED["multi_stream"]
        self.cfg = dict(cfg)
        self.levels = levels
        enc = [f * 2 ** i for i in range(levels)]
        dec = enc
        lat = [max(f // 4, 1) * 2 ** i for i in range(levels)]
        self.lat = lat
        chunk = cfg["vil_chunk_size"]
        self.skip_return, self.mid_vil = cfg["skip_return"], cfg["mid_vil"]
        self.coupled = cfg["seg_recon_decoder"]
        self.init_blocks = QConv3d(M, M * enc[0], 1, groups=M)
        for lv in range(levels):
            cin = enc[0] if lv == 0 else enc[lv - 1]
            self.add_module(f"encoders_{lv}", StreamEncoder(M, cin, enc[lv], lv > 0))
            self.add_module(f"drb_{lv}", stream_conv(M * enc[lv], M * 2 * lat[lv], 2, M))
            self.add_module(f"vu_{lv}", BasicConv(lat[lv], dec[lv], 1))
            self.add_module(f"conv_block_{lv}", BasicConv(dec[lv], dec[lv], 3, dec[lv]))
        if self.skip_return:
            self.x0_init = QConv3d(M, enc[0], 1)
            for lv in range(1, levels):
                self.add_module(f"skr_att_{lv}", SkrGate(enc[lv - 1]))
                self.add_module(f"skr_encoder_{lv}", Encoder(enc[lv - 1], enc[lv]))
        if self.mid_vil:
            self.mvil = ViL3D(dec[-1], chunk)
        rev = dec[::-1]
        for j in range(levels - 1):
            cin = rev[j] + rev[j + 1]
            if cfg["vil_decoder"] and j == 0:
                sbasic = DoubleConvViL(cin, rev[j + 1], chunk)
            else:
                sbasic = double_conv(cin, rev[j + 1], False)
            self.add_module(f"sdecoder_{j}", Decoder(sbasic, atten=True))
            self.add_module(f"rdecoder_0_{j}", Decoder(double_conv(cin, rev[j + 1], False)))
            if self.coupled and j < DUSE_LEVELS:
                self.add_module(f"dusfe_{j}", DuSE(rev[j + 1]))
        self.rfinal_0 = QConv3d(rev[-1], M, 1)
        if self.coupled:
            self.sfinal_0 = QConv3d(rev[-1], M, 1)
            self.final_conv = QConv3d(M, 3, 1)
        else:
            self.final_conv = QConv3d(rev[-1], 3, 1)

    def latent(self, lv, mu, logvar, keep, noise):
        pd_mu, pd_logvar = product_of_experts(mu, logvar, keep)
        z = pd_mu if noise is None else pd_mu + noise * torch.exp(0.5 * pd_logvar)
        z = getattr(self, f"vu_{lv}")(z)
        z = upsample(z, [2 * s for s in z.shape[2:]])
        return getattr(self, f"conv_block_{lv}")(z)

    def forward(self, x, keep, noise: Optional[List[torch.Tensor]] = None):
        """x (B, 4, D, H, W), keep (4,) bool. `noise`: one standard normal
        tensor per level in the latents' shape, or None for the means."""
        B, M = x.shape[:2]
        xs = self.init_blocks(x)
        mus, logvars, feats = [], [], []
        skr = None
        for lv in range(self.levels):
            if skr is not None:
                xs = getattr(self, f"skr_att_{lv}")(skr) * xs + xs
            xs = getattr(self, f"encoders_{lv}")(xs)
            drb = getattr(self, f"drb_{lv}")(xs)
            drb = drb.reshape(B, M, 2 * self.lat[lv], *drb.shape[2:])
            mu, logvar = stack_prior(drb[:, :, :self.lat[lv]], drb[:, :, self.lat[lv]:])
            mus.append(mu)
            logvars.append(logvar)
            feats.insert(0, self.latent(lv, mu, logvar, keep,
                                        None if noise is None else noise[lv]))
            if self.skip_return:
                skr = (self.x0_init(x) if skr is None
                       else getattr(self, f"skr_encoder_{lv}")(skr))
        if self.mid_vil:
            feats[0] = feats[0] + self.mvil(feats[0] + skr if skr is not None else feats[0])
        bottleneck, skips = feats[0], feats[1:]
        rx = sx = bottleneck
        for j in range(self.levels - 1):
            rx = getattr(self, f"rdecoder_0_{j}")(skips[j], rx)
            sx = getattr(self, f"sdecoder_{j}")(skips[j], sx)
            if self.coupled and j < DUSE_LEVELS:
                rx, sx = getattr(self, f"dusfe_{j}")(rx, sx)
        head = self.final_conv(self.sfinal_0(sx) if self.coupled else sx)
        return Output(torch.sigmoid(head), tuple(mus), tuple(logvars), self.rfinal_0(rx))


class DiscBlock(nn.Module):
    def __init__(self, cin, cout, kernel, stride, normalize):
        super().__init__()
        self.normalize = normalize
        self.Conv_0 = QConv3d(cin, cout, kernel, stride, padding=1)

    def forward(self, x):
        x = self.Conv_0(x)
        return F.leaky_relu(instance_norm(x) if self.normalize else x, 0.2)


class Discriminator(nn.Module):
    """k^3 convs with padding 1 at strides 1, 2, 2, 2 and f_maps * 2^i maps,
    InstanceNorm from the second on, LeakyReLU 0.2, then a bias-free k^3
    conv to one map."""

    def __init__(self, in_channels=7, f_maps=64, kernel=4, levels=4, strides=(1, 2, 2, 2)):
        super().__init__()
        cin = in_channels
        for i in range(levels):
            self.add_module(f"block{i}", DiscBlock(cin, f_maps * 2 ** i, kernel, strides[i],
                                                   i > 0))
            cin = f_maps * 2 ** i
        self.levels = levels
        self.last = QConv3d(cin, 1, kernel, bias=False, padding=1)

    def forward(self, x):
        for i in range(self.levels):
            x = getattr(self, f"block{i}")(x)
        return self.last(x)
