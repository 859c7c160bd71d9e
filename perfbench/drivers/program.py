"""Building the program under test and its plain reference from a
configuration file, with the same weights made from the seed."""
from __future__ import annotations

import torch

from perfbench.reference import model as ref_model
from perfbench.weights import draw_state

# keys of a configuration's "model" that are not fields of the program's config
_NOT_FIELDS = ("preset",)


def program_config(model: dict):
    """The program's HVEDConfig of the preset, checked against every field
    the configuration file states."""
    from xlstm_hved_torch.config import get_config

    cfg = get_config(model["preset"], compute_dtype=model["compute_dtype"], remat=False)
    for key, value in model.items():
        if key in _NOT_FIELDS:
            continue
        have = getattr(cfg, key)
        if (list(have) if isinstance(have, tuple) else have) != value:
            raise ValueError(f"{model['preset']}.{key} is {have!r}, the configuration "
                             f"file states {value!r}")
    return cfg


def reference_modules(config: dict, device, disc: bool):
    with torch.device(device):
        g = ref_model.HVED(config["model"])
        d = None
        if disc:
            d = ref_model.Discriminator(7, config["disc"]["f_maps"], config["disc"]["kernel"])
    return g, d


def make_weights(config: dict, generator: torch.Generator, disc: bool):
    """The state dicts of G (and D) drawn from the generator on its device.
    The templates' construction values (the default init of conv and dense
    biases among them) are drawn under a seed taken from the generator, so
    the seed fixes every value; the process's own random state is left as
    it was."""
    dev = generator.device
    seed = int(torch.randint(2**62, (1,), generator=generator, device=dev))
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        g, d = reference_modules(config, dev, disc)
    wg = draw_state(g, generator)
    wd = draw_state(d, generator) if disc else None
    return wg, wd


def build_program(config: dict, weights_g, weights_d, device):
    """The program's G (and D, when weights_d is given) on the device,
    loaded strictly with the weights."""
    from xlstm_hved_torch.models.hved import Discriminator, HVEDFusionNet
    from xlstm_hved_torch.nn.blocks import compute_dtype

    with torch.device(device):
        g = HVEDFusionNet(program_config(config["model"]))
        d = None
        if weights_d is not None:
            dc = config["disc"]
            d = Discriminator(7, dc["f_maps"], dc["kernel"], dtype=compute_dtype(dc["dtype"]))
    g.load_state_dict(weights_g, strict=True)
    if d is not None:
        d.load_state_dict(weights_d, strict=True)
    return g, d


def build_reference(config: dict, weights_g, weights_d, device, precision: str = "float32"):
    from perfbench.reference.precision import quantizer

    g, d = reference_modules(config, device, weights_d is not None)
    g.load_state_dict(weights_g, strict=True)
    ref_model.set_quant(g, *quantizer(precision))
    if d is not None:
        d.load_state_dict(weights_d, strict=True)
        ref_model.set_quant(d, *quantizer(precision))
    return g, d


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

