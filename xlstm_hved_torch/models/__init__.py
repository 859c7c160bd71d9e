"""Model-zoo factory for every HVED preset of the zoo, and the
discriminator. The JAX registry also serves the U_HeMIS baseline, which the
port does not have yet."""
from __future__ import annotations

import torch

from xlstm_hved_torch.config import MODEL_ALIASES, HVEDConfig, get_config
from xlstm_hved_torch.models.hved import Discriminator, HVEDFusionNet, HVEDOutput


def resolve_device(device) -> torch.device:
    """The device the caller asked for; a CUDA request with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def find_model_using_name(name: str, *, device="cuda", seed: int = 0,
                          **overrides) -> HVEDFusionNet:
    """name -> HVEDFusionNet in eval mode on `device`, with weights drawn
    from `seed` (the global RNG is left as it was). Config fields can be
    overridden by keyword."""
    if MODEL_ALIASES.get(name, name) == "U_HeMIS":
        raise NotImplementedError(
            "U_HeMIS (the JAX package's models/hemis.py) is not ported yet: ROADMAP.md "
            "queue A9")
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = HVEDFusionNet(get_config(name, **overrides))
    return model.to(device).eval()


__all__ = [
    "Discriminator",
    "HVEDConfig",
    "HVEDFusionNet",
    "HVEDOutput",
    "find_model_using_name",
    "get_config",
    "resolve_device",
]
