"""The builder of the UxLSTM nets (a configuration with "builder":
"uxlstm"): the program's net and its plain reference (`reference/uxlstm.py`)
from the configuration's nnU-Net plan, with the same weights made from the
seed, and the shapes of its ViLs' mLSTM calls.

The configuration's "model" holds the plan's fields as nnU-Net writes them
(`patch_size`, `conv_kernel_sizes`, `pool_op_kernel_sizes`,
`n_conv_per_stage_encoder`, `n_conv_per_stage_decoder`,
`UNet_base_num_features`, `unet_max_num_features`), the net's own
(`in_channels`, `out_channels`, `deep_supervision`, `variant`,
`compute_dtype`) and what the construction should come to
(`features_per_stage`, `mixers`, `channel_token`, `vil_chunk_size`), which
`program_config` checks against the program's net."""
from __future__ import annotations

import math

import torch

from perfbench.reference import uxlstm as ref_uxlstm
from perfbench.weights import draw_state

PLAN_KEYS = ("patch_size", "conv_kernel_sizes", "pool_op_kernel_sizes",
             "n_conv_per_stage_encoder", "n_conv_per_stage_decoder",
             "UNet_base_num_features", "unet_max_num_features")


def plan(model: dict) -> dict:
    return {k: model[k] for k in PLAN_KEYS}


def _build(model: dict, device):
    from xlstm_hved_torch.models import build_uxlstm_from_plans
    from xlstm_hved_torch.nn.blocks import compute_dtype

    with torch.device(device):
        return build_uxlstm_from_plans(plan(model), model["in_channels"], model["out_channels"],
                                       model["deep_supervision"], model["variant"],
                                       compute_dtype(model["compute_dtype"]))


def program_config(model: dict) -> dict:
    """The program's net of the plan, built without storage, checked against
    every field the configuration states; returns the plan."""
    net = _build(model, "meta")
    enc, dec = net.encoder, net.decoder
    mixers = [getattr(enc, f"mixer{s}", None) for s in range(enc.n_stages)]
    vils = [m for m in mixers if hasattr(m, "vil")]
    heads = [getattr(dec, f"seg{s}") for s in range(1, dec.n_stages) if hasattr(dec, f"seg{s}")]
    conv = enc.stem_res.conv1
    built = {
        "in_channels": conv.in_channels,
        "out_channels": heads[0].out_channels,
        "deep_supervision": len(heads) == dec.n_stages - 1,
        "variant": {"UXlstmEnc": "enc", "UXlstmBot": "bot"}[type(net).__name__],
        "compute_dtype": str(conv.compute_dtype or torch.float32).replace("torch.", ""),
        "features_per_stage": [getattr(enc, f"stage{s}_res").conv1.out_channels
                               for s in range(enc.n_stages)],
        "mixers": list(enc.mixers),
        "channel_token": [bool(getattr(m, "channel_token", False)) for m in mixers],
        "vil_chunk_size": vils[0].vil.layer.mlstm_cell.chunk_size if vils else None,
    }
    for key, value in model.items():
        if key in PLAN_KEYS:
            continue
        if key not in built:
            raise ValueError(f"{key}: not a field of the UxLSTM configuration")
        if built[key] != value:
            raise ValueError(f"{key} is {built[key]!r} in the program's net, the configuration "
                             f"file states {value!r}")
    return plan(model)


def vil_sites(model: dict, traffic: dict):
    """(batch x heads, tokens, head width, chunk) of each ViL mixer's mLSTM
    call at the traffic's patch and batch, shallowest first: over the map's
    voxels (tokens the voxels, dim the channels) or, with channel tokens,
    over its channels (dim the voxels)."""
    _, _, _, _, sizes = ref_uxlstm.plan_shape(dict(plan(model), patch_size=traffic["patch"]))
    out = []
    for s, kind in enumerate(model["mixers"]):
        if kind != "vil":
            continue
        voxels, feats = math.prod(sizes[s]), model["features_per_stage"][s]
        tokens, dim = (feats, voxels) if model["channel_token"][s] else (voxels, feats)
        heads = 4 if dim % 4 == 0 else 2  # nn/vil.py: ViLLayer's mLSTM, inner width 2 * dim
        out.append((traffic["batch"] * heads, tokens, 2 * dim // heads, model["vil_chunk_size"]))
    return out


def reference_module(model: dict, device):
    with torch.device(device):
        return ref_uxlstm.UXlstmEnc3d(plan(model), model["in_channels"], model["out_channels"])


def make_weights(model: dict, generator: torch.Generator):
    """The state dict drawn from the generator on its device; the template's
    construction values under a seed taken from the generator, so the seed
    fixes every value and the process's own random state is left as it was."""
    dev = generator.device
    seed = int(torch.randint(2**62, (1,), generator=generator, device=dev))
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        template = reference_module(model, dev)
    return draw_state(template, generator)


def build_program(model: dict, weights, device):
    net = _build(model, device)
    net.load_state_dict(weights, strict=True)
    return net


def build_reference(model: dict, weights, device, precision: str = "float32"):
    from perfbench.reference.precision import quantizer

    net = reference_module(model, device)
    net.load_state_dict(weights, strict=True)
    return ref_uxlstm.set_quant(net, *quantizer(precision))
