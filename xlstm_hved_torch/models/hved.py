"""The HVED fusion network in NCDHW (counterpart of
`xlstm_hved_tpu/models/hved.py::HVEDFusionNet`, full mode).

Four modality streams are folded into channel blocks of one tensor (stream m
owns channels [m*C, (m+1)*C)) and run through grouped convs. Per level the
streams' DRB heads give Gaussian experts, fused with the N(0, 1) prior by a
masked product of experts over the keep-mask; the sample (or the mean when
`deterministic`) is upsampled by the VU block into the decoder skip. The
skip-return chain gates each stream's encoder input, a ViL block mixes the
bottleneck tokens, and the seg and recon decoders are coupled by DuSE.

`mode="prefix"` / `"suffix"` split the forward at the subset-invariance
boundary for the hoisted 15-subset sweep (`engine/evaluate.py`): a dropped
stream's features reach only its own expert, which the product of experts
weights by 0 (`ops/poe.py`), and the per-stream convs are grouped, so the
kept streams see the same values whether the dropped ones were zeroed or
not. `prefix(x_full)` runs the hoisted levels' encoders and DRBs once on
the full input; `suffix(x_masked, keep, prefix)` runs their keep-dependent
latent tails and the rest. The hoist is every level without skip-return and
level 0 with it: the skr gate chain starts from the masked input
(`x0_init`) and gates every stream from level 1 on.

Precision follows the JAX model's: with `compute_dtype="bfloat16"` the input
is cast to bf16 and every conv and dense layer computes in bf16, set in one
pass when the model is built (parameters, BatchNorm
statistics and gradients stay fp32); the experts are cast to fp32 before the
product of experts, which runs in fp32 with the reparametrisation, and the
sample is cast back; the ViL is an fp32 island; seg and recon come out fp32.
"float32" casts nothing (the parameters' dtype, so an fp64 copy of the model
runs in fp64). With `remat` the encoder, DRB and decoder stages recompute
their insides in the backward (`torch.utils.checkpoint`) while gradients are
taken, as the JAX model's `nn.remat` stages do.

Every `MODEL_ZOO` preset builds: the MVAE presets with the double-conv or
the ext-resnet basic module (`U_HVEDNet3D`: residual blocks in the
encoders, a 1x1 `pre_conv` before each decoder upsampling, sum joins in the
recon ladder), the ViL decoder block of U_HVEDConvXLSTMNet3D, one shared
recon stream or one per modality (`shared_recon=False`, the pretrain net),
and the non-MVAE arms: the fusion arm of `FusionUNet3D` (per level a
FusionModule gates the keep-masked streams and compresses them for the
half-width recon ladder; the seg decoder starts from `last_compress` of the
last level's streams and joins the per-modality skips by concat) and the
plain multi-stream concat. Also the config arms no preset sets:
single-stream deep levels (`fusion_level < num_levels`: an EncoderStage on
the level above's decoder feature, as the JAX model implements it),
`mvae_reduction=False` (the encoder's streams are the experts; no DRB, no
VU block), `recon_skip=False` (the recon ladder upsamples x2 with no
skip), `recon_decoder=False` and `final_sigmoid=False` (a softmax over the
channels). And the PatchGAN `Discriminator` of the adversarial train step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from xlstm_hved_torch.config import HVEDConfig, features_per_level
from xlstm_hved_torch.nn.blocks import (BasicConv, BlockDiagEncoderStage,
                                        BlockDiagSingleConv, Conv3d, DecoderStage,
                                        EncoderStage, at_least_fp32, block_diag_conv,
                                        compute_dtype, conv3d, resize_trilinear,
                                        set_compute_dtype)
from xlstm_hved_torch.nn.dusfe import DuSEAttention
from xlstm_hved_torch.nn.gates import DISC_PADDING, DiscriminatorBlock, FusionModule
from xlstm_hved_torch.nn.skr import SkrGate
from xlstm_hved_torch.nn.vil import DropPath, ViLLayer3D
from xlstm_hved_torch.ops.poe import product_of_experts, reparametrize, stack_prior


# DuSE couples the first three decoder levels (the reference's j <= 2)
_DUSE_LEVELS = 3


class HVEDOutput(NamedTuple):
    seg: Optional[torch.Tensor]          # (B, 3, D, H, W) probabilities
    mu: Tuple[torch.Tensor, ...]         # per level (B, 5, C, D', H', W')
    logvar: Tuple[torch.Tensor, ...]
    recon: Optional[torch.Tensor]        # (B, 4, D, H, W)


class HoistedPrefix(NamedTuple):
    """What `mode="prefix"` returns: the expert stacks of the hoisted levels
    and, when deeper levels remain (skip-return models hoist level 0 only),
    the folded stream tensor at the hoist boundary."""

    mu: Tuple[torch.Tensor, ...]
    logvar: Tuple[torch.Tensor, ...]
    xs: Optional[torch.Tensor]


MODES = ("full", "prefix", "suffix")


# the stage types the JAX model wraps in nn.remat under cfg.remat
REMAT_STAGES = (BlockDiagEncoderStage, EncoderStage, DecoderStage, BlockDiagSingleConv)


class HVEDFusionNet(nn.Module):
    def __init__(self, cfg: HVEDConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        M = cfg.multi_stream
        levels = cfg.num_levels
        n_ms = min(cfg.fusion_level, levels)  # the multi-stream levels
        if cfg.fusion and n_ms < levels:
            raise ValueError(
                "the fusion arm needs fusion_level >= num_levels: its seg decoder reads one "
                "per-modality skip list per decoder stage, and the JAX model indexes past "
                "them otherwise")
        enc_f, dec_f, lat = cfg.enc_f_maps, cfg.dec_f_maps, cfg.mvae_latents
        order, groups, basic = cfg.layer_order, cfg.num_groups, cfg.basic_module
        mvae = cfg.mvae and not cfg.fusion

        self.init_blocks = block_diag_conv(M, cfg.in_channels, enc_f[0], 1)
        # channels of each level's decoder feature, what the recon decoder
        # and (but in the fusion arm) the seg decoder take as a skip
        feat_ch = []
        for lv in range(levels):
            if lv >= n_ms:
                # single-stream deep level: an encoder on the level above's
                # decoder feature
                self.add_module(f"encoders_{lv}", EncoderStage(
                    feat_ch[-1], dec_f[lv], cfg.num_block[lv], order, basic,
                    num_groups=groups))
                feat_ch.append(dec_f[lv])
                continue
            cin = enc_f[0] if lv == 0 else enc_f[lv - 1]
            self.add_module(f"encoders_{lv}", BlockDiagEncoderStage(
                M, cin, enc_f[lv], cfg.num_block[lv], apply_pooling=lv > 0, order=order,
                basic_module=basic))
            if cfg.fusion:
                # the fused features feed the half-width recon ladder
                self.add_module(f"fusion_{lv}", FusionModule(
                    M * enc_f[lv], dec_f[lv] // 2, "modal", M))
                feat_ch.append(dec_f[lv] // 2)
            elif mvae and cfg.mvae_reduction:
                self.add_module(f"drb_{lv}", BlockDiagSingleConv(
                    M, enc_f[lv], 2 * lat[lv], stride=2, order=order))
                self.add_module(f"vu_{lv}", BasicConv(lat[lv], dec_f[lv], 1))
                self.add_module(f"conv_block_{lv}", BasicConv(
                    dec_f[lv], dec_f[lv], 3, groups=dec_f[lv]))
                feat_ch.append(dec_f[lv])
            elif mvae:
                # the encoder's streams are the experts' mu and logvar
                feat_ch.append(lat[lv])
            else:
                # plain multi-stream: the kept streams concatenated
                feat_ch.append(M * enc_f[lv])
        if cfg.skip_return:
            self.x0_init = conv3d(M * cfg.in_channels, enc_f[0], 1)
            for lv in range(1, levels):
                if lv < n_ms:
                    self.add_module(f"skr_att_{lv}", SkrGate(enc_f[lv - 1]))
                self.add_module(f"skr_encoder_{lv}", EncoderStage(
                    enc_f[lv - 1], enc_f[lv], cfg.num_block[lv], order, basic,
                    num_groups=groups))
        if cfg.mvae and cfg.mid_vil:
            self.mvil = ViLLayer3D(dec_f[-1], cfg.vil_chunk_size, cfg.mlstm_kernel)

        rev_dec = list(reversed(dec_f))
        rev_rec = list(reversed(features_per_level(cfg.rec_f_maps, levels)))
        rev_feat = feat_ch[::-1]
        # the fusion arm's seg decoder joins the per-modality streams
        rev_seg = [M * c for c in enc_f[::-1]] if cfg.fusion else rev_feat
        seg_in = rev_feat[0]
        if cfg.fusion:
            # the seg bottleneck compresses the concatenated last-level streams
            self.last_compress = BasicConv(rev_seg[0], rev_dec[0], 1)
            seg_in = rev_dec[0]
        # one recon stream shared by the M modalities (M output channels), or
        # one stream per modality (1 output channel each)
        self.rec_streams = 1 if cfg.shared_recon else M
        rec_last = M if cfg.shared_recon else 1
        has_recon = cfg.recon_decoder or cfg.seg_recon_decoder
        rec_skip = cfg.recon_skip or cfg.seg_recon_decoder
        for j in range(levels - 1):
            # the ViL decoder block sits in seg decoder stage 0 only
            stage_basic = "double_conv_vil" if cfg.vil_decoder and j == 0 else basic
            self.add_module(f"sdecoder_{j}", DecoderStage(
                seg_in if j == 0 else rev_dec[j], rev_seg[j + 1], rev_dec[j + 1],
                rsm=cfg.mvae, order=order, basic_module=stage_basic,
                mlstm_kernel=cfg.mlstm_kernel, mvae=cfg.mvae, num_groups=groups))
            for m in range(self.rec_streams if has_recon else 0):
                self.add_module(f"rdecoder_{m}_{j}", DecoderStage(
                    rev_feat[0] if j == 0 else rev_rec[j],
                    rev_feat[j + 1] if rec_skip else 0, rev_rec[j + 1], order=order,
                    basic_module=basic, num_groups=groups))
            if cfg.seg_recon_decoder and j < _DUSE_LEVELS:
                self.add_module(f"dusfe_{j}", DuSEAttention(rev_dec[j + 1]))
        for m in range(self.rec_streams if has_recon else 0):
            self.add_module(f"rfinal_{m}", conv3d(rev_rec[-1], rec_last, 1))
        if cfg.seg_recon_decoder:
            self.sfinal_0 = conv3d(rev_dec[-1], rec_last, 1)
            self.final_conv = conv3d(rec_last, cfg.out_channels, 1)
        else:
            self.final_conv = conv3d(rev_dec[-1], cfg.out_channels, 1)
        set_compute_dtype(self, self.dtype)

    def _stage(self, name: str, *args):
        """Run the named stage; under `cfg.remat`, while gradients are taken,
        as a checkpoint whose insides are recomputed in the backward. The
        recompute must draw what the first pass drew: a DropPath with a
        non-zero rate (drawn from an explicit generator, which the checkpoint
        does not restore) is refused there."""
        stage = getattr(self, name)
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return stage(*args)
        if any(isinstance(m, DropPath) and m.rate > 0 for m in stage.modules()):
            raise NotImplementedError(
                f"remat of {name}: a DropPath with a non-zero rate would draw again in "
                "the recompute")
        return checkpoint(stage, *args, use_reentrant=False)

    def _latent(self, lv: int, mu_e, logvar_e, keep_b, deterministic, generator):
        """The keep-dependent tail of an MVAE level: the product of the kept
        experts, the sample (or the mean), and with `mvae_reduction` the VU
        block (1x1 conv, x2 trilinear, depthwise conv)."""
        pd_mu, pd_logvar = product_of_experts(mu_e, logvar_e, keep_b)
        z = reparametrize(pd_mu, pd_logvar, deterministic, generator)
        z = z.to(self.dtype or z.dtype)
        if not self.cfg.mvae_reduction:
            return z
        z = getattr(self, f"vu_{lv}")(z)
        z = resize_trilinear(z, [2 * s for s in z.shape[2:]])
        return getattr(self, f"conv_block_{lv}")(z)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None, *,
                instance_missing: bool = False, seg: bool = True,
                recon: bool = False, deterministic: bool = False,
                generator: Optional[torch.Generator] = None, mode: str = "full",
                prefix: Optional[HoistedPrefix] = None):
        """x: (B, M, D, H, W). keep: (4,) or (B, 4) bool, True = present; by
        default all present, or inferred per instance from all-zero channels
        when `instance_missing`. Sampling (deterministic=False) draws its
        noise from `generator`. BatchNorm follows the module's train/eval
        mode.

        mode "full" returns an HVEDOutput; "prefix" the HoistedPrefix of the
        full input x; "suffix" the HVEDOutput of the subset-masked input x
        and its keep-mask, resuming from `prefix` (module docstring). The
        fusion and plain multi-stream models have no experts (empty mu and
        logvar) and run in full mode only."""
        cfg = self.cfg
        M = cfg.multi_stream
        B = x.shape[0]
        levels = cfg.num_levels
        n_ms = min(cfg.fusion_level, levels)
        mvae = cfg.mvae and not cfg.fusion
        div = 2 ** levels
        if cfg.mvae and any(s % div for s in x.shape[2:]):
            raise ValueError(
                f"spatial dims {tuple(x.shape[2:])} must be divisible by "
                f"2^num_levels = {div} for the MVAE x2-upsample path")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "full":
            if not mvae:
                raise ValueError(
                    "hoisted prefix/suffix modes require an MVAE model (the fusion "
                    "and plain multi-stream arms read unmasked stream features)")
            if mode == "suffix" and prefix is None:
                raise ValueError("mode='suffix' needs the HoistedPrefix")
        # multi-stream levels whose encoder and DRB are subset-invariant
        hoist = 0 if mode == "full" else (1 if cfg.skip_return else n_ms)
        if keep is None:
            if instance_missing:
                keep = x.abs().sum(dim=(2, 3, 4)) != 0
            else:
                keep = torch.ones(M, dtype=torch.bool, device=x.device)
        keep = torch.as_tensor(keep, device=x.device).bool()
        keep_b = keep[None, :].expand(B, M) if keep.ndim == 1 else keep
        lat = cfg.mvae_latents

        x = x.to(self.dtype or self.init_blocks.weight.dtype)
        xs = prefix.xs if mode == "suffix" else self.init_blocks(x)
        mu_list, logvar_list, rec_feats, seg_feats = [], [], [], []
        skr_feat = None

        def skr_advance(lv):
            if skr_feat is None:
                return self.x0_init(x)
            return self._stage(f"skr_encoder_{lv}", skr_feat)

        for lv in range(levels):
            if lv >= n_ms:
                rec_feats.insert(0, self._stage(f"encoders_{lv}", rec_feats[0]))
                if cfg.skip_return and mode != "prefix":
                    skr_feat = skr_advance(lv)
                continue
            if mode == "suffix" and lv < hoist:
                mu_e, logvar_e = prefix.mu[lv], prefix.logvar[lv]
                mu_list.append(mu_e)
                logvar_list.append(logvar_e)
                rec_feats.insert(0, self._latent(lv, mu_e, logvar_e, keep_b,
                                                 deterministic, generator))
                if cfg.skip_return:
                    skr_feat = skr_advance(lv)
                continue
            if cfg.skip_return and skr_feat is not None:
                gate = getattr(self, f"skr_att_{lv}")(skr_feat)
                xs = gate * xs + xs
            xs = self._stage(f"encoders_{lv}", xs)
            if mvae:
                # folded (B, M*2L, ...) -> (B, M, 2L, ...): mu first, logvar
                # second; the experts in fp32 whatever the compute dtype
                drb = self._stage(f"drb_{lv}", xs) if cfg.mvae_reduction else xs
                drb = at_least_fp32(drb)
                drb = drb.reshape(B, M, 2 * lat[lv], *drb.shape[2:])
                mu_e, logvar_e = stack_prior(drb[:, :, :lat[lv]], drb[:, :, lat[lv]:])
                mu_list.append(mu_e)
                logvar_list.append(logvar_e)
                if mode == "prefix":
                    if lv == hoist - 1:
                        return HoistedPrefix(tuple(mu_list), tuple(logvar_list),
                                             xs if hoist < n_ms else None)
                    continue
                rec_feats.insert(0, self._latent(lv, mu_e, logvar_e, keep_b,
                                                 deterministic, generator))
            else:
                # a dropped stream's features are zeroed before they are used
                feats = [f * keep_b[:, m].to(f.dtype).view(B, 1, 1, 1, 1)
                         for m, f in enumerate(xs.chunk(M, dim=1))]
                rec_feats.insert(0, getattr(self, f"fusion_{lv}")(feats)[0] if cfg.fusion
                                 else torch.cat(feats, dim=1))
                seg_feats.insert(0, feats)
            if cfg.skip_return:
                skr_feat = skr_advance(lv)

        if cfg.mvae and cfg.mid_vil:
            vil_in = rec_feats[0] + skr_feat if skr_feat is not None else rec_feats[0]
            rec_feats[0] = rec_feats[0] + self.mvil(vil_in)

        bottleneck, skips = rec_feats[0], rec_feats[1:]
        seg_out = recon_out = None
        recons = []
        want_recon = recon and cfg.recon_decoder
        if cfg.seg_recon_decoder:
            # coupled decode: DuSE mixes the recon and seg branches per level,
            # so the recon ladder runs whenever seg does. With a recon stream
            # per modality the shared seg ladder and DuSE run again for each,
            # from the bottleneck; the seg head reads the last stream's.
            for m in range(self.rec_streams):
                rx = sx = bottleneck
                for j in range(levels - 1):
                    rx = self._stage(f"rdecoder_{m}_{j}", skips[j], rx)
                    if seg:
                        sx = self._stage(f"sdecoder_{j}", skips[j], sx)
                        if j < _DUSE_LEVELS:
                            rx, sx = getattr(self, f"dusfe_{j}")(rx, sx)
                if want_recon:
                    recons.append(getattr(self, f"rfinal_{m}")(rx))
            if seg:
                seg_out = self._head(self.sfinal_0(sx))
        else:
            for m in range(self.rec_streams if want_recon else 0):
                rx = bottleneck
                for j in range(levels - 1):
                    if cfg.recon_skip:
                        rx = self._stage(f"rdecoder_{m}_{j}", skips[j], rx)
                    else:
                        rx = self._stage(f"rdecoder_{m}_{j}", None, rx,
                                         [2 * s for s in rx.shape[2:]])
                recons.append(getattr(self, f"rfinal_{m}")(rx))
            if seg:
                if cfg.fusion:
                    sx = self.last_compress(torch.cat(seg_feats[0], dim=1))
                    seg_skips = seg_feats[1:]
                else:
                    sx, seg_skips = bottleneck, skips
                for j in range(levels - 1):
                    sx = self._stage(f"sdecoder_{j}", seg_skips[j], sx)
                seg_out = self._head(sx)
        if want_recon:
            recon_out = at_least_fp32(
                recons[0] if len(recons) == 1 else torch.cat(recons, dim=1))
        return HVEDOutput(seg_out, tuple(mu_list), tuple(logvar_list), recon_out)

    def _head(self, x):
        """final_conv, then sigmoid (or softmax over the channels without
        `final_sigmoid`), returned in fp32."""
        logits = self.final_conv(x)
        probs = torch.sigmoid(logits) if self.cfg.final_sigmoid else torch.softmax(logits, 1)
        return at_least_fp32(probs)


class Discriminator(nn.Module):
    """PatchGAN-style 3D conv discriminator on concat(seg, attention-weighted
    recon) (counterpart of `xlstm_hved_tpu/models/hved.py::Discriminator`):
    `num_levels` DiscriminatorBlocks of f_maps * 2^i channels with the given
    strides, InstanceNorm from the second on, then a bias-free k^3 conv to
    one channel. x: (B, in_channels, D, H, W). `dtype` is D's own compute
    dtype (the CLIs' --disc_dtype; None = the parameters'); the output is in
    it, and the LSGAN losses read it in fp32."""

    def __init__(self, in_channels: int = 7, f_maps: int = 64, kernel: int = 4,
                 num_levels: int = 4, strides: Tuple[int, ...] = (1, 2, 2, 2),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel, self.num_levels = kernel, num_levels
        feats = [f_maps * 2 ** i for i in range(num_levels)]
        cin = in_channels
        for i, f in enumerate(feats):
            self.add_module(f"block{i}", DiscriminatorBlock(
                cin, f, kernel=kernel, stride=strides[i], normalize=i > 0))
            cin = f
        self.last = Conv3d(cin, 1, kernel, padding=DISC_PADDING, bias=False)
        set_compute_dtype(self, dtype)

    def check_input(self, spatial):
        """Raise ValueError when a (D, H, W) input leaves the final conv no
        support after the blocks' downsampling."""
        for i in range(self.num_levels):
            conv = getattr(self, f"block{i}").Conv_0
            spatial = [(n + 2 * DISC_PADDING - self.kernel) // conv.stride[0] + 1
                       for n in spatial]
        if min(spatial) + 2 * DISC_PADDING < self.kernel:
            raise ValueError(
                f"Discriminator input too small: spatial {tuple(spatial)} after "
                f"downsampling leaves no support for the final k={self.kernel} "
                "conv; use a larger crop or kernel=3")

    def forward(self, x):
        self.check_input(x.shape[2:])
        for i in range(self.num_levels):
            x = getattr(self, f"block{i}")(x)
        return self.last(x)
