"""Test-only inverse of `xlstm_hved_torch/utils/torch_import.py`: a port
state dict -> the state dict of the upstream (PyTorch) XLSTM-HVED code under
its own key names, as an upstream `.pth` holds it.

Each port key matches exactly one rule (a key no rule names raises, so the
inverse covers the whole port model); a grouped conv of the folded streams
splits along dim 0 into its per-stream upstream convs. The tests hold the
result to the JAX package's importers, the independent judge of the
upstream names. This module imports no JAX, so `chip_smoke.py` can write
upstream checkpoints with it on the card machine.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Tuple

import torch

Rule = Tuple[str, Callable, int]   # (port key regex, groups -> upstream key, streams)
_DOUBLE_CONV = {"conv1": "SingleConv1", "conv2": "SingleConv2"}
_EXT_RESNET = {"conv1": "conv1", "conv2": "conv2"}


def _apply(state: Mapping[str, torch.Tensor], rules: List[Rule]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in state.items():
        hits = [(m, fn, s) for pat, fn, s in rules for m in [re.fullmatch(pat, key)] if m]
        if len(hits) != 1:
            raise KeyError(f"{key}: {len(hits)} upstream rules match, expected 1")
        match, fn, streams = hits[0]
        g = match.groups()
        if streams == 1:
            out[fn(g)] = value.clone()
        else:
            for m, part in enumerate(value.chunk(streams, dim=0)):
                out[fn(g + (m,))] = part.clone()
    return out


def _sub(cfg_module: str) -> Dict[str, str]:
    return _EXT_RESNET if cfg_module == "ext_resnet" else _DOUBLE_CONV


def hved_upstream(state, cfg) -> Dict[str, torch.Tensor]:
    """Port HVEDFusionNet(cfg) state dict -> upstream AbstractFusion3DUNet
    names (the MVAE presets)."""
    M, L, sc, dc = cfg.multi_stream, cfg.num_levels, _sub(cfg.basic_module), _DOUBLE_CONV
    rec = "srdecoder.multi_decoders" if cfg.seg_recon_decoder else "rdecoder.multi_decoders"
    rec_sc = dc if cfg.seg_recon_decoder else sc
    rules: List[Rule] = [
        (r"init_blocks\.(\w+)", lambda g: f"init_blocks.{g[1]}.0.{g[0]}", M),
        (r"encoders_(\d+)\.block(\d+)\.(conv[12])\.conv\.(\w+)",
         lambda g: f"encoders.{g[0]}.{g[4]}.basic_module.{g[1]}.{sc[g[2]]}.conv.{g[3]}", M),
        (r"encoders_(\d+)\.block(\d+)\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"encoders.{g[0]}.basic_module.{g[1]}.{sc[g[2]]}.conv.{g[3]}", 1),
        (r"drb_(\d+)\.conv\.(\w+)", lambda g: f"DRBs.{g[0]}.{g[2]}.0.conv.{g[1]}", M),
        (r"vu_(\d+)\.conv\.weight", lambda g: f"VU_blocks.{g[0]}.0.conv.weight", 1),
        (r"conv_block_(\d+)\.conv\.weight", lambda g: f"conv_blocks.{g[0]}.conv.weight", 1),
        (r"sdecoder_(\d+)\.atten\.(\w+)\.(\w+)",
         lambda g: f"decoders.{g[0]}.atten_module.{g[1]}.{g[2]}", 1),
        (r"sdecoder_(\d+)\.basic\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"decoders.{g[0]}.basic_module.{sc[g[1]]}.conv.{g[2]}", 1),
        (r"sdecoder_(\d+)\.basic\.double_conv\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"decoders.{g[0]}.basic_module.{dc[g[1]]}.conv.{g[2]}", 1),
        (r"sdecoder_(\d+)\.basic\.vil\.(vil\..+)",
         lambda g: f"decoders.{g[0]}.basic_module.ViL.{g[1]}", 1),
        (r"sdecoder_(\d+)\.pre_conv\.(\w+)",
         lambda g: f"decoders.{g[0]}.upsampling.conv1.{g[1]}", 1),
        (r"final_conv\.(\w+)", lambda g: f"final_conv.{g[0]}", 1),
        (r"rdecoder_(\d+)_(\d+)\.basic\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"{rec}.{g[0]}.{g[1]}.basic_module.{rec_sc[g[2]]}.conv.{g[3]}", 1),
        (r"rdecoder_(\d+)_(\d+)\.pre_conv\.(\w+)",
         lambda g: f"rdecoder.multi_decoders.{g[0]}.{g[1]}.upsampling.conv1.{g[2]}", 1),
        (r"rfinal_(\d+)\.(\w+)",
         lambda g: (f"srdecoder.rfinals.{g[0]}.{g[1]}" if cfg.seg_recon_decoder
                    else f"rdecoder.finals.{g[0]}.{g[1]}"), 1),
        (r"sfinal_0\.(\w+)", lambda g: f"srdecoder.sfinals.0.{g[0]}", 1),
        (r"dusfe_(\d+)\.(.+)", lambda g: f"srdecoder.dusfe_decoders.{g[0]}.{g[1]}", 1),
        (r"mvil\.(.+)", lambda g: f"mViL.{g[0]}", 1),
        (r"x0_init\.(\w+)", lambda g: f"x0_init.0.{g[0]}", 1),
        (r"skr_att_(\d+)\.res\.(conv[12])\.BatchNorm_0\.(\w+)",
         lambda g: f"skr_att.{L - int(g[0])}.0.{g[1]}.norm.{g[2]}", 1),
        (r"skr_att_(\d+)\.res\.(conv[12])\.(dwconv|pwconv)\.(\w+)",
         lambda g: f"skr_att.{L - int(g[0])}.0.{g[1]}.{g[2]}.{g[3]}", 1),
        (r"skr_att_(\d+)\.sa\.conv\.weight",
         lambda g: f"skr_att.{L - int(g[0])}.1.conv.weight", 1),
        (r"skr_encoder_(\d+)\.block(\d+)\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"skr_encoders.{L - 1 - int(g[0])}.basic_module.{g[1]}.{dc[g[2]]}"
                   f".conv.{g[3]}", 1),
    ]
    return _apply(state, rules)


def fusion_upstream(state, cfg) -> Dict[str, torch.Tensor]:
    """Port HVEDFusionNet(cfg) state dict of the fusion arm -> upstream
    FusionUNet3D names."""
    M, sc = cfg.multi_stream, _sub(cfg.basic_module)
    rules: List[Rule] = [
        (r"init_blocks\.(\w+)", lambda g: f"init_blocks.{g[1]}.0.{g[0]}", M),
        (r"encoders_(\d+)\.block(\d+)\.(conv[12])\.conv\.(\w+)",
         lambda g: f"encoders.{g[0]}.{g[4]}.basic_module.{g[1]}.{sc[g[2]]}.conv.{g[3]}", M),
        (r"fusion_(\d+)\.gate\.Dense_([01])\.(\w+)",
         lambda g: f"FBs.{g[0]}.gate.mlp.{2 * int(g[1]) + 1}.{g[2]}", 1),
        (r"fusion_(\d+)\.compress\.conv\.weight",
         lambda g: f"FBs.{g[0]}.compress.conv.weight", 1),
        (r"last_compress\.conv\.weight", lambda g: "last_compress.conv.weight", 1),
        (r"sdecoder_(\d+)\.basic\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"decoders.{g[0]}.basic_module.{sc[g[1]]}.conv.{g[2]}", 1),
        (r"final_conv\.(\w+)", lambda g: f"final_conv.{g[0]}", 1),
        (r"rdecoder_(\d+)_(\d+)\.basic\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"rdecoder.multi_decoders.{g[0]}.{g[1]}.basic_module.{sc[g[2]]}"
                   f".conv.{g[3]}", 1),
        (r"rfinal_(\d+)\.(\w+)", lambda g: f"rdecoder.finals.{g[0]}.{g[1]}", 1),
    ]
    return _apply(state, rules)


_HEMIS_STAGES = (1, 3, 5, 7)
_HEMIS_DECODERS = ("d3_c1", "d2_c1", "d1_c1")


def hemis_upstream(state, streams: int = 4) -> Dict[str, torch.Tensor]:
    """Port UHeMIS state dict -> upstream U_HeMIS names."""
    dc = _DOUBLE_CONV

    def dec(name):
        return ("seg_decoder" if name == "seg_decoder"
                else f"recon_decoder_list.{name.rsplit('_', 1)[1]}")

    rules: List[Rule] = [
        (r"encoders\.init\.conv\.weight", lambda g: f"enc_list.{g[0]}.encoder.0.conv.weight",
         streams),
        (r"encoders\.block(\d)\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"enc_list.{g[3]}.encoder.{_HEMIS_STAGES[int(g[0])]}.{dc[g[1]]}"
                   f".conv.{g[2]}", streams),
        (r"(recon_decoder_\d+|seg_decoder)\.dec(\d)\.(conv[12])\.Conv3DFast_0\.(\w+)",
         lambda g: f"{dec(g[0])}.{_HEMIS_DECODERS[int(g[1])]}.{dc[g[2]]}.conv.{g[3]}", 1),
        (r"(recon_decoder_\d+|seg_decoder)\.final\.conv\.weight",
         lambda g: f"{dec(g[0])}.final_conv.conv.weight", 1),
    ]
    return _apply(state, rules)


def uxlstm_upstream(state) -> Dict[str, torch.Tensor]:
    """Port UXlstmEnc / UXlstmBot state dict (2-D or 3-D) -> upstream
    UxLSTM names (BasicResBlock for the res blocks, nnU-Net's BasicBlockD
    for the extra blocks and the conv mixers)."""
    rules: List[Rule] = [
        (r"encoder\.stem_res\.(.+)", lambda g: f"encoder.stem.0.{g[0]}", 1),
        (r"encoder\.stem_block(\d+)\.(conv|norm)([12])\.(\w+)",
         lambda g: f"encoder.stem.{int(g[0]) + 1}.conv{g[2]}.{g[1]}.{g[3]}", 1),
        (r"encoder\.stage(\d+)_res\.(.+)", lambda g: f"encoder.stages.{g[0]}.0.{g[1]}", 1),
        (r"encoder\.stage(\d+)_block(\d+)\.(conv|norm)([12])\.(\w+)",
         lambda g: f"encoder.stages.{g[0]}.{int(g[1]) + 1}.conv{g[3]}.{g[2]}.{g[4]}", 1),
        (r"encoder\.mixer(\d+)\.(conv|norm)([12])\.(\w+)",
         lambda g: f"encoder.xlstm_layers.{g[0]}.conv{g[2]}.{g[1]}.{g[3]}", 1),
        (r"encoder\.mixer(\d+)\.(vil\..+)", lambda g: f"encoder.xlstm_layers.{g[0]}.{g[1]}", 1),
        (r"decoder\.up(\d+)_conv\.(\w+)",
         lambda g: f"decoder.upsample_layers.{int(g[0]) - 1}.conv.{g[1]}", 1),
        (r"decoder\.dec(\d+)_res\.(.+)", lambda g: f"decoder.stages.{int(g[0]) - 1}.0.{g[1]}", 1),
        (r"decoder\.dec(\d+)_block(\d+)\.(conv|norm)([12])\.(\w+)",
         lambda g: f"decoder.stages.{int(g[0]) - 1}.{int(g[1]) + 1}.conv{g[3]}.{g[2]}.{g[4]}",
         1),
        (r"decoder\.seg(\d+)\.(\w+)", lambda g: f"decoder.seg_layers.{int(g[0]) - 1}.{g[1]}", 1),
        (r"xlstm\.(vil\..+)", lambda g: f"xlstm.{g[0]}", 1),
    ]
    return _apply(state, rules)


def disc_upstream(state) -> Dict[str, torch.Tensor]:
    """Port Discriminator state dict -> upstream Discriminator names."""
    rules: List[Rule] = [
        (r"block(\d+)\.Conv_0\.(\w+)", lambda g: f"disc.{g[0]}.0.{g[1]}", 1),
        (r"last\.weight", lambda g: "last.weight", 1),
    ]
    return _apply(state, rules)
