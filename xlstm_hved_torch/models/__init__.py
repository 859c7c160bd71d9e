"""Model-zoo factory: every HVED preset of the zoo and the U_HeMIS
baseline by name, and the discriminator; the UxLSTM nnU-Nets from a plans
dict."""
from __future__ import annotations

import torch

from xlstm_hved_torch.config import MODEL_ALIASES, MODEL_ZOO, HVEDConfig, get_config
from xlstm_hved_torch.models.hemis import UHeMIS
from xlstm_hved_torch.models.hved import Discriminator, HVEDFusionNet, HVEDOutput
from xlstm_hved_torch.models.uxlstm import UXlstmBot, UXlstmEnc, build_uxlstm_from_plans
from xlstm_hved_torch.nn.blocks import compute_dtype


def resolve_device(device) -> torch.device:
    """The device the caller asked for; a CUDA request with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def find_model_using_name(name: str, *, device="cuda", seed: int = 0, **overrides):
    """name -> the model in eval mode on `device`, with weights drawn from
    `seed` (the global RNG is left as it was): an HVEDFusionNet whose config
    fields can be overridden by keyword, or for "U_HeMIS" a UHeMIS taking
    its own arguments (`compute_dtype` becomes its `dtype`; the HVED-only
    `remat` is dropped, as the JAX registry does)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if MODEL_ALIASES.get(name, name) == "U_HeMIS":
            kw = dict(overrides)
            if "compute_dtype" in kw:
                kw["dtype"] = compute_dtype(kw.pop("compute_dtype"))
            kw.pop("remat", None)
            model = UHeMIS(**kw)
        else:
            model = HVEDFusionNet(get_config(name, **overrides))
    return model.to(device).eval()


def available_models():
    """Every name `find_model_using_name` builds."""
    return sorted(set(MODEL_ZOO) | set(MODEL_ALIASES) | {"U_HeMIS"})


__all__ = [
    "Discriminator",
    "HVEDConfig",
    "HVEDFusionNet",
    "HVEDOutput",
    "UHeMIS",
    "UXlstmBot",
    "UXlstmEnc",
    "available_models",
    "build_uxlstm_from_plans",
    "find_model_using_name",
    "get_config",
    "resolve_device",
]
