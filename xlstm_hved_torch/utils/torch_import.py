"""Import upstream (PyTorch) XLSTM-HVED checkpoints into the port
(counterpart of `xlstm_hved_tpu/utils/torch_import.py`; the function names
are the JAX module's).

The upstream repository trains with torch and saves `{'model_sd':
state_dict, ...}`. Each function here takes such a state dict (torch
tensors or numpy arrays) and returns the port model's `state_dict`, which
loads with `load_state_dict(strict=True)`. Upstream weights are already in
torch layout, so an import is a key rename, with one layout rule: the
upstream per-modality `ModuleList` copies of a conv fold into the port's
grouped conv by concatenation along dim 0 (stream m owns outputs
[m*cout, (m+1)*cout)), the layout `utils/convert.py::params_from_jax` gives
a block-diagonal kernel. Depthwise and grouped convs, Linear layers,
CausalConv1d (C, 1, k) and the norms' tensors are taken as they are;
`num_batches_tracked` is set to 0, as `params_from_jax` sets it. Values are
fp32 on the CPU.

The keys read are the JAX importer's: upstream weights that its forward
never reaches are not read (the ViL wrapper's own `norm`, DuSE's
`conv_fuse_ch*` adjuncts, the skr gates' `identity_mapping`, the DRB / VU /
conv-block twins at single-stream deep levels, the fusion seg decoders'
`atten_module`, the unused UxLSTM seg heads), and a key that is read and
missing raises KeyError naming it.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Sequence

import numpy as np
import torch

from xlstm_hved_torch.config import HVEDConfig

State = Dict[str, torch.Tensor]
_CONV = ("weight", "bias")
_WEIGHT = ("weight",)
_BN = ("weight", "bias", "running_mean", "running_var")


def _tensor(value) -> torch.Tensor:
    """A copy of `value` as a contiguous fp32 CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32, copy=True).contiguous()
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _copy(out: State, sd: Mapping, dst: str, src: str, names: Sequence[str] = _CONV):
    """dst.{name} <- src.{name} for each name."""
    for name in names:
        out[f"{dst}.{name}"] = _tensor(sd[f"{src}.{name}"])


def _stacked(out: State, sd: Mapping, dst: str, srcs: Iterable[str],
             names: Sequence[str] = _CONV):
    """The per-stream upstream convs `srcs` -> one grouped conv `dst`."""
    srcs = list(srcs)
    for name in names:
        out[f"{dst}.{name}"] = torch.cat([_tensor(sd[f"{s}.{name}"]) for s in srcs])


def _batch_norm(out: State, sd: Mapping, dst: str, src: str):
    _copy(out, sd, dst, src, _BN)
    out[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def _sub_names(module: str):
    """Upstream child names of a basic module's two convs: DoubleConv's
    SingleConv1 / SingleConv2, ExtResNetBlock's conv1 / conv2."""
    return ("conv1", "conv2") if module == "ext_resnet" else ("SingleConv1", "SingleConv2")


def _basic_folded(out: State, sd: Mapping, dst: str, key_fmt: Callable, streams: int,
                  module: str = "double_conv"):
    """Per-stream upstream basic modules -> a folded BlockDiag block."""
    for port, sub in zip(("conv1", "conv2"), _sub_names(module)):
        _stacked(out, sd, f"{dst}.{port}.conv",
                 (f"{key_fmt(m, sub)}.conv" for m in range(streams)))


def _basic_plain(out: State, sd: Mapping, dst: str, src: str, module: str = "double_conv"):
    """An upstream basic module -> DoubleConv / ExtResNetBlock (SingleConvs
    whose conv is `Conv3DFast_0`)."""
    for port, sub in zip(("conv1", "conv2"), _sub_names(module)):
        _copy(out, sd, f"{dst}.{port}.Conv3DFast_0", f"{src}.{sub}.conv")


def _atten2(out: State, sd: Mapping, dst: str, src: str):
    """AttenModule2: the grouped 7^3 gates and their pointwise convs."""
    for name in ("enc_spatial", "enc_spatial2", "seg_spatial", "seg_spatial2"):
        _copy(out, sd, f"{dst}.{name}", f"{src}.{name}")


def _duse(out: State, sd: Mapping, dst: str, src: str):
    """DuSEAttention (its unused conv_fuse_ch* adjuncts are not read)."""
    for name in ("fc_comb", "fc_ch1", "fc_ch2", "conv_squeeze_ch1", "conv_squeeze_ch2",
                 "conv_comb", "conv_adjust_ch1", "conv_adjust_ch2"):
        _copy(out, sd, f"{dst}.{name}", f"{src}.{name}")
    for name in ("bn_fuse_ch1", "bn_fuse_ch2"):
        _batch_norm(out, sd, f"{dst}.{name}", f"{src}.{name}")


_VIL_LAYER = (("proj_up", _WEIGHT), ("q_proj", _WEIGHT), ("k_proj", _WEIGHT),
              ("v_proj", _WEIGHT), ("conv1d.conv", _CONV), ("mlstm_cell.igate", _CONV),
              ("mlstm_cell.fgate", _CONV), ("mlstm_cell.outnorm", _WEIGHT),
              ("proj_down", _WEIGHT))


def _vil3d(out: State, sd: Mapping, dst: str, src: str):
    """The upstream ViLLayer wrapper -> ViLLayer3D / ViLMixerND (`dst.vil`
    is the ViLBlock). The wrapper's own LayerNorm, never called in its
    forward, is not read."""
    _copy(out, sd, f"{dst}.vil.norm", f"{src}.vil.norm", _WEIGHT)
    for name, names in _VIL_LAYER:
        _copy(out, sd, f"{dst}.vil.layer.{name}", f"{src}.vil.layer.{name}", names)
    _copy(out, sd, f"{dst}.vil.layer", f"{src}.vil.layer", ("learnable_skip",))


def _dwconvnorm(out: State, sd: Mapping, dst: str, src: str):
    """DWConvNorm: depthwise conv, pointwise conv, BatchNorm."""
    _copy(out, sd, f"{dst}.dwconv", f"{src}.dwconv", _WEIGHT)
    _copy(out, sd, f"{dst}.pwconv", f"{src}.pwconv")
    _batch_norm(out, sd, f"{dst}.BatchNorm_0", f"{src}.norm")


def _skr_gate(out: State, sd: Mapping, dst: str, src: str):
    """Sequential(ResBlock(lkdw), SpacialAttention3D(k=1)) -> SkrGate. The
    ResBlock's `identity_mapping` is dead weight where channels and stride
    are kept (always, in a gate) and is not read."""
    _dwconvnorm(out, sd, f"{dst}.res.conv1", f"{src}.0.conv1")
    _dwconvnorm(out, sd, f"{dst}.res.conv2", f"{src}.0.conv2")
    _copy(out, sd, f"{dst}.sa.conv", f"{src}.1.conv", _WEIGHT)


def _double_conv_vil(out: State, sd: Mapping, dst: str, src: str):
    """DoubleConv_ViL -> DoubleConvViL (double_conv + vil)."""
    _basic_plain(out, sd, f"{dst}.double_conv", src)
    _vil3d(out, sd, f"{dst}.vil", f"{src}.ViL")


def hved_params_from_torch(sd: Mapping, cfg: HVEDConfig) -> State:
    """An upstream AbstractFusion3DUNet state dict -> the state dict of the
    port's HVEDFusionNet(cfg), for the MVAE presets with the reduction
    (double-conv and ext-resnet basic modules, DuSFE, the ViL decoder, the
    skr / mid-ViL flagship). Other configs raise NotImplementedError, as
    the JAX importer's do."""
    if cfg.basic_module not in ("double_conv", "ext_resnet"):
        raise NotImplementedError(
            f"torch import: unsupported basic_module={cfg.basic_module!r}")
    if not cfg.mvae or not cfg.mvae_reduction:
        raise NotImplementedError(
            "torch import currently requires the MVAE+reduction zoo config "
            "(the fusion family is mapped by fusion_params_from_torch)")
    bm = cfg.basic_module
    ext = bm == "ext_resnet"
    M, L = cfg.multi_stream, cfg.num_levels
    n_dec = L - 1
    out: State = {}

    _stacked(out, sd, "init_blocks", (f"init_blocks.{m}.0" for m in range(M)))
    n_ms = min(cfg.fusion_level, L)
    for i in range(L):
        if i >= n_ms:
            # a single-stream deep level: upstream stores a bare Encoder; its
            # DRB / VU / conv-block twins are never reached and not read
            for b in range(cfg.num_block[i]):
                _basic_plain(out, sd, f"encoders_{i}.block{b}",
                             f"encoders.{i}.basic_module.{b}", bm)
            continue
        for b in range(cfg.num_block[i]):
            _basic_folded(out, sd, f"encoders_{i}.block{b}",
                          lambda m, sc, i=i, b=b: f"encoders.{i}.{m}.basic_module.{b}.{sc}",
                          M, bm)
        _stacked(out, sd, f"drb_{i}.conv", (f"DRBs.{i}.{m}.0.conv" for m in range(M)))
        _copy(out, sd, f"vu_{i}.conv", f"VU_blocks.{i}.0.conv", _WEIGHT)
        _copy(out, sd, f"conv_block_{i}.conv", f"conv_blocks.{i}.conv", _WEIGHT)

    for j in range(n_dec):
        src = f"decoders.{j}.basic_module"
        if cfg.vil_decoder and j < 1:
            _double_conv_vil(out, sd, f"sdecoder_{j}.basic", src)
        else:
            _basic_plain(out, sd, f"sdecoder_{j}.basic", src, bm)
        _atten2(out, sd, f"sdecoder_{j}.atten", f"decoders.{j}.atten_module")
        if ext:
            _copy(out, sd, f"sdecoder_{j}.pre_conv", f"decoders.{j}.upsampling.conv1")
    _copy(out, sd, "final_conv", "final_conv")

    rec_streams = 1 if cfg.shared_recon else M
    if cfg.seg_recon_decoder:
        for m in range(rec_streams):
            for j in range(n_dec):
                _basic_plain(out, sd, f"rdecoder_{m}_{j}.basic",
                             f"srdecoder.multi_decoders.{m}.{j}.basic_module")
            _copy(out, sd, f"rfinal_{m}", f"srdecoder.rfinals.{m}")
        _copy(out, sd, "sfinal_0", "srdecoder.sfinals.0")
        for j in range(min(n_dec, 3)):
            _duse(out, sd, f"dusfe_{j}", f"srdecoder.dusfe_decoders.{j}")
    elif cfg.recon_decoder:
        for m in range(rec_streams):
            for j in range(n_dec):
                src = f"rdecoder.multi_decoders.{m}.{j}"
                _basic_plain(out, sd, f"rdecoder_{m}_{j}.basic", f"{src}.basic_module", bm)
                if ext:
                    _copy(out, sd, f"rdecoder_{m}_{j}.pre_conv", f"{src}.upsampling.conv1")
            _copy(out, sd, f"rfinal_{m}", f"rdecoder.finals.{m}")

    if cfg.mid_vil:
        _vil3d(out, sd, "mvil", "mViL")
    if cfg.skip_return:
        # upstream builds skr_att / skr_encoders by insert(0, ...) over levels
        # 1..L-1, so index 0 is the deepest: skr_att_{l} <- skr_att.{L-l},
        # skr_encoder_{l} <- skr_encoders.{L-1-l}; skr_att.0 is never reached
        _copy(out, sd, "x0_init", "x0_init.0")
        for level in range(1, L):
            if level < n_ms:  # gates only at the multi-stream levels
                _skr_gate(out, sd, f"skr_att_{level}", f"skr_att.{L - level}")
            for b in range(cfg.num_block[level]):
                _basic_plain(out, sd, f"skr_encoder_{level}.block{b}",
                             f"skr_encoders.{L - 1 - level}.basic_module.{b}")
    return out


def hemis_params_from_torch(sd: Mapping, streams: int = 4) -> State:
    """An upstream U_HeMIS state dict -> the port's UHeMIS state dict. The
    per-modality ConvEncoders (`enc_list.{m}`: Sequential 0 the bias-free
    init conv, 1/3/5/7 the blocks) fold into the one grouped-conv stack."""
    out: State = {}
    _stacked(out, sd, "encoders.init.conv",
             (f"enc_list.{m}.encoder.0.conv" for m in range(streams)), _WEIGHT)
    for b, idx in enumerate((1, 3, 5, 7)):
        for port, sub in (("conv1", "SingleConv1"), ("conv2", "SingleConv2")):
            _stacked(out, sd, f"encoders.block{b}.{port}.Conv3DFast_0",
                     (f"enc_list.{m}.encoder.{idx}.{sub}.conv" for m in range(streams)))

    def decoder(dst: str, src: str):
        for j, name in enumerate(("d3_c1", "d2_c1", "d1_c1")):
            _basic_plain(out, sd, f"{dst}.dec{j}", f"{src}.{name}")
        _copy(out, sd, f"{dst}.final.conv", f"{src}.final_conv.conv", _WEIGHT)

    for m in range(streams):
        decoder(f"recon_decoder_{m}", f"recon_decoder_list.{m}")
    decoder("seg_decoder", "seg_decoder")
    return out


def fusion_params_from_torch(sd: Mapping, cfg: HVEDConfig) -> State:
    """An upstream FusionUNet3D state dict (the fusion=True non-MVAE path)
    -> the port's HVEDFusionNet(cfg) state dict. The seg decoders'
    `atten_module`, which the upstream forward cannot run, is not read."""
    if not cfg.fusion or cfg.mvae:
        raise ValueError("fusion_params_from_torch takes the fusion arm; the MVAE "
                         "presets are mapped by hved_params_from_torch")
    M, L = cfg.multi_stream, cfg.num_levels
    out: State = {}
    _stacked(out, sd, "init_blocks", (f"init_blocks.{m}.0" for m in range(M)))
    for i in range(L):
        for b in range(cfg.num_block[i]):
            _basic_folded(out, sd, f"encoders_{i}.block{b}",
                          lambda m, sc, i=i, b=b: f"encoders.{i}.{m}.basic_module.{b}.{sc}",
                          M, cfg.basic_module)
        # FusionModule: the modality gate's MLP and the bias-free 1x1 compress
        _copy(out, sd, f"fusion_{i}.gate.Dense_0", f"FBs.{i}.gate.mlp.1")
        _copy(out, sd, f"fusion_{i}.gate.Dense_1", f"FBs.{i}.gate.mlp.3")
        _copy(out, sd, f"fusion_{i}.compress.conv", f"FBs.{i}.compress.conv", _WEIGHT)
    _copy(out, sd, "last_compress.conv", "last_compress.conv", _WEIGHT)
    for j in range(L - 1):
        _basic_plain(out, sd, f"sdecoder_{j}.basic", f"decoders.{j}.basic_module",
                     cfg.basic_module)
    _copy(out, sd, "final_conv", "final_conv")
    for m in range(1 if cfg.shared_recon else M):
        for j in range(L - 1):
            _basic_plain(out, sd, f"rdecoder_{m}_{j}.basic",
                         f"rdecoder.multi_decoders.{m}.{j}.basic_module", cfg.basic_module)
        _copy(out, sd, f"rfinal_{m}", f"rdecoder.finals.{m}")
    return out


def _ux_res(out: State, sd: Mapping, dst: str, src: str, block):
    """Upstream BasicResBlock -> ResBlockND (conv3, the 1x1 skip, where the
    port's block has one)."""
    for name in ("conv1", "norm1", "conv2", "norm2"):
        _copy(out, sd, f"{dst}.{name}", f"{src}.{name}")
    if block.conv3 is not None:
        _copy(out, sd, f"{dst}.conv3", f"{src}.conv3")


def _ux_block_d(out: State, sd: Mapping, dst: str, src: str):
    """nnU-Net's BasicBlockD (conv{1,2}.{conv,norm}; its all_modules.* keys
    alias the same tensors) -> ResBlockND without a conv3."""
    for i in (1, 2):
        _copy(out, sd, f"{dst}.conv{i}", f"{src}.conv{i}.conv")
        _copy(out, sd, f"{dst}.norm{i}", f"{src}.conv{i}.norm")


def uxlstm_params_from_torch(sd: Mapping, model) -> State:
    """An upstream UXlstmEnc / UXlstmBot state dict (2-D or 3-D; the twins
    share the key layout) -> the state dict of the port's `model`, whose
    structure (stages, block counts, mixers, deep supervision) says what is
    read. Only conv_bias=True checkpoints are taken (what the upstream
    plans factory builds). Without deep supervision only the last seg head
    is read."""
    from xlstm_hved_torch.models.uxlstm import UXlstmBot, UXlstmEnc

    if "encoder.stem.0.conv1.bias" not in sd:
        raise NotImplementedError("uxlstm import requires conv_bias=True checkpoints")
    if not isinstance(model, (UXlstmEnc, UXlstmBot)):
        raise TypeError(f"expected the port's UXlstmEnc or UXlstmBot, got {type(model)}")
    enc, dec = model.encoder, model.decoder
    out: State = {}
    _ux_res(out, sd, "encoder.stem_res", "encoder.stem.0", enc.stem_res)
    for b in range(enc.n_blocks[0] - 1):
        _ux_block_d(out, sd, f"encoder.stem_block{b}", f"encoder.stem.{1 + b}")
    for s in range(enc.n_stages):
        _ux_res(out, sd, f"encoder.stage{s}_res", f"encoder.stages.{s}.0",
                getattr(enc, f"stage{s}_res"))
        for b in range(enc.n_blocks[s] - 1):
            _ux_block_d(out, sd, f"encoder.stage{s}_block{b}", f"encoder.stages.{s}.{1 + b}")
        # the "none" stages are nn.Identity upstream: no parameters
        if enc.mixers[s] == "conv":
            _ux_block_d(out, sd, f"encoder.mixer{s}", f"encoder.xlstm_layers.{s}")
        elif enc.mixers[s] == "vil":
            _vil3d(out, sd, f"encoder.mixer{s}", f"encoder.xlstm_layers.{s}")

    for s in range(1, dec.n_stages):
        _copy(out, sd, f"decoder.up{s}_conv", f"decoder.upsample_layers.{s - 1}.conv")
        _ux_res(out, sd, f"decoder.dec{s}_res", f"decoder.stages.{s - 1}.0",
                getattr(dec, f"dec{s}_res"))
        for b in range(dec.n_conv[s - 1] - 1):
            _ux_block_d(out, sd, f"decoder.dec{s}_block{b}", f"decoder.stages.{s - 1}.{1 + b}")
        if dec.deep_supervision or s == dec.n_stages - 1:
            _copy(out, sd, f"decoder.seg{s}", f"decoder.seg_layers.{s - 1}")
    if model.bottleneck_vil:
        _vil3d(out, sd, "xlstm", "xlstm")
    return out


def disc_params_from_torch(sd: Mapping, num_levels: int = 4) -> State:
    """An upstream Discriminator state dict (blocks Sequential[Conv3d,
    InstanceNorm3d (no parameters), LeakyReLU]) -> the port's Discriminator
    state dict (block{i}.Conv_0, last)."""
    out: State = {}
    for i in range(num_levels):
        _copy(out, sd, f"block{i}.Conv_0", f"disc.{i}.0")
    _copy(out, sd, "last", "last", _WEIGHT)
    return out


def load_reference_checkpoint(path: str, cfg: HVEDConfig) -> State:
    """An upstream .pth checkpoint (`{'model_sd': ...}` or a bare state dict)
    -> the port's HVEDFusionNet(cfg) state dict. The file is unpickled
    (`weights_only=False`, as upstream saves optimiser state beside the
    weights): load only checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_sd", ckpt) if isinstance(ckpt, dict) else ckpt
    return hved_params_from_torch(sd, cfg)
