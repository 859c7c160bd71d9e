"""Configuration tree, model-zoo presets and training hyperparameters.

The port's own copy of `xlstm_hved_tpu/config.py` (the port imports nothing
from the JAX package): the same `HVEDConfig` flags, the same zoo, the same
aliases and the same `TrainConfig`, so a name resolves to the same
architecture and the same training set-up in both packages.
One compute-policy field differs: `mlstm_kernel` picks the CUDA mLSTM
kernels where the JAX config picked its Pallas kernels. `compute_dtype`
("float32" or "bfloat16") and `remat` (stage rematerialisation while
gradients are taken) are the JAX fields, and so is `num_groups`, the
GroupNorm group count of the "g" layer-order char (no preset uses it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def features_per_level(init: int, num_levels: int) -> Tuple[int, ...]:
    """[f, 2f, 4f, ...] per level."""
    return tuple(init * (2 ** k) for k in range(num_levels))


@dataclasses.dataclass(frozen=True)
class HVEDConfig:
    """Architecture flags of the HVED fusion network plus compute policy."""

    in_channels: int = 1          # per modality stream
    out_channels: int = 3         # WT / TC / ET sigmoid channels
    f_maps: int = 4
    layer_order: str = "ilc"
    num_levels: int = 4
    num_block: Tuple[int, ...] = (1, 1, 1, 1)
    multi_stream: int = 4
    fusion_level: int = 4
    basic_module: str = "double_conv"   # double_conv | ext_resnet
    final_sigmoid: bool = True
    num_groups: int = 8

    # MVAE latent stage
    mvae: bool = True
    mvae_reduction: bool = True

    # decoders / aux paths
    recon_decoder: bool = True
    seg_recon_decoder: bool = True
    recon_skip: bool = True
    shared_recon: bool = True
    skip_return: bool = False
    mid_vil: bool = False
    vil_decoder: bool = False           # DoubleConvViL in decoder stage 0
    fusion: bool = False                # non-MVAE FusionModule path

    # compute policy
    compute_dtype: str = "float32"      # or "bfloat16" (the CLIs' default)
    vil_chunk_size: int = 128
    # None = auto: the CUDA mLSTM kernels when the tensors are on the card,
    # the plain chunkwise scan when they are on the CPU. False asks for the
    # plain scan on the card too (a comparison baseline).
    mlstm_kernel: Optional[bool] = None
    remat: bool = False                 # recompute the encoder / decoder / DRB
    # stages in the backward (torch.utils.checkpoint per stage); the
    # parameter names do not change

    # ---- derived ----
    @property
    def enc_f_maps(self) -> Tuple[int, ...]:
        return features_per_level(self.f_maps, self.num_levels)

    @property
    def dec_f_maps(self) -> Tuple[int, ...]:
        if self.mvae:
            if self.mvae_reduction:
                return features_per_level(self.f_maps, self.num_levels)
            if self.basic_module == "double_conv":
                return features_per_level(self.f_maps, self.num_levels)
            return features_per_level(self.f_maps // 2, self.num_levels)
        return features_per_level(self.f_maps * self.multi_stream, self.num_levels)

    @property
    def mvae_latents(self) -> Tuple[int, ...]:
        base = self.f_maps // 4 if self.mvae_reduction else self.f_maps // 2
        return features_per_level(max(base, 1), self.num_levels)

    @property
    def rec_f_maps(self) -> int:
        return self.dec_f_maps[0] if self.mvae else self.dec_f_maps[0] // 2


# Flagship construction kwargs shared by every zoo entry.
_BASE = dict(
    f_maps=4, layer_order="ilc", multi_stream=4, fusion_level=4,
    shared_recon=True, recon_skip=True, mvae_reduction=True, final_sigmoid=True,
)


def _cfg(**kw) -> HVEDConfig:
    merged = dict(_BASE)
    merged.update(kw)
    return HVEDConfig(**merged)


MODEL_ZOO = {
    # basic conv HVED without MVAE (fusion module path)
    "FusionUNet3D": _cfg(mvae=False, fusion=True, basic_module="double_conv",
                         seg_recon_decoder=False, mvae_reduction=False),
    # residual-Unet U-HVED
    "U_HVEDNet3D": _cfg(mvae=True, basic_module="ext_resnet",
                        seg_recon_decoder=False),
    # original U-HVED (conv)
    "U_HVEDConvNet3D": _cfg(mvae=True, seg_recon_decoder=False),
    # + ViL decoder blocks
    "U_HVEDConvXLSTMNet3D": _cfg(mvae=True, seg_recon_decoder=False,
                                 vil_decoder=True),
    # + DuSFE coupled seg/recon decoder
    "U_HVEDConvDuSFENet3D": _cfg(mvae=True, seg_recon_decoder=True),
    # + skip-return
    "U_HVEDConvDuSFESkrNet3D": _cfg(mvae=True, seg_recon_decoder=True,
                                    skip_return=True),
    # + mid-ViL (no skr)
    "U_HVEDConvDuSFEmViLNet3D": _cfg(mvae=True, seg_recon_decoder=True,
                                     mid_vil=True),
    # + mid-ViL + skr
    "U_HVEDConvDuSFEmViLSkrNet3D": _cfg(mvae=True, seg_recon_decoder=True,
                                        skip_return=True, mid_vil=True),
    # flagship: DuSFE + Skr + mid-ViL
    "XLSTM_HVED": _cfg(mvae=True, seg_recon_decoder=True, skip_return=True,
                       mid_vil=True),
    # ablations
    "XLSTM_HVED_woSMVAE": _cfg(mvae=True, seg_recon_decoder=True,
                               skip_return=False, mid_vil=True),
    "XLSTM_HVED_woViL": _cfg(mvae=True, seg_recon_decoder=True,
                             skip_return=True, mid_vil=False),
    "XLSTM_HVED_woDuSFE": _cfg(mvae=True, seg_recon_decoder=False,
                               skip_return=True, mid_vil=True),
}

# Registry names that map onto a zoo entry (same table as the JAX package).
MODEL_ALIASES = {
    "U_HVEDConvDuSFEmViLNet3D_pretrain": "U_HVEDConvDuSFEmViLNet3D",
    "U_HVEDDuSFEmViLDFNet3D": "U_HVEDConvDuSFEmViLSkrNet3D",
    "XLSTM_HVED_missing1": "XLSTM_HVED",
    "RA_HVED": "XLSTM_HVED",
    "XLSTM_HVED_drop_vil": "XLSTM_HVED_woViL",
    "XLSTM_HVED_woME_VAEback": "XLSTM_HVED",
    "XLSTM_HVED_woME_VAEback_woViL": "XLSTM_HVED_woViL",
    "XLSTM_HVED_woME_VAEback_CK": "XLSTM_HVED",
    "XLSTM_HVED_woME_VAEback_ViLAtt": "XLSTM_HVED",
    "XLSTM_HVED_woME_VAEback_ViLAtt_woskip_vil_m1": "XLSTM_HVED",
    "XLSTM_HVED_woME_VAEback_ViLAtt_DC": "XLSTM_HVED",
    "XLSTM_HVED_woME_VAEback_ViLAtt_DC_noPretrain": "XLSTM_HVED",
}


def get_config(name: str, **overrides) -> HVEDConfig:
    name = MODEL_ALIASES.get(name, name)
    if name not in MODEL_ZOO:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_ZOO)}")
    cfg = MODEL_ZOO[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX package's defaults)."""

    num_epochs: int = 3000
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    weight_adv: float = 0.1     # alpha
    weight_vae: float = 0.2     # beta
    use_sdm: bool = False       # add the boundary loss <seg, SDM(gt)>
    weight_bd: float = 0.5      # boundary-loss weight
    poly_power: float = 0.9
    crop_size: Tuple[int, int, int] = (128, 192, 128)
    train_batch: int = 1
    valid_batch: int = 1
    seed: int = 1
    validate_every: int = 1
    backup_interval: int = 5
    disc_f_maps: int = 64
    disc_kernel: int = 4
    steps_per_epoch: Optional[int] = None
