"""Weights and statistics made from the seed, on the device, in a few calls.

The template is a module of the plain reference, built on the device: its
state dict gives every name and shape, and its construction values. One
standard normal draw covers all of it; each tensor takes a slice:
- a weight of two or more axes: He-normal, std sqrt(2 / fan-in), with the
  fan-in of a conv or dense weight, and the last axis of the three-axis
  ones (the headwise projections, the depthwise causal conv);
- a one-axis parameter: its construction value plus 0.1 of a normal draw
  (BatchNorm scales near 1, the ViL's norm offsets near 0, its skip near 1,
  its forget-gate biases near 3..6);
- BatchNorm running means: 0.1 of a draw; running variances: exp(0.2 of a
  draw); step counts as constructed.
The same state dict loads, by name, into the program and into the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _spec(name: str, t: torch.Tensor):
    """(std, keep the construction value, exponentiate) of one tensor."""
    if name.endswith("running_mean"):
        return 0.1, False, False
    if name.endswith("running_var"):
        return 0.2, False, True
    if t.ndim >= 2:
        fan_in = t.shape[-1] if t.ndim == 3 else math.prod(t.shape[1:])
        return math.sqrt(2.0 / fan_in), False, False
    return 0.1, True, False


@torch.no_grad()
def draw_state(template: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    sd = template.state_dict()
    floats = [(n, t) for n, t in sd.items() if t.is_floating_point()]
    specs = [_spec(n, t) for n, t in floats]
    dev = generator.device
    counts = torch.tensor([t.numel() for _, t in floats], device=dev)
    std = torch.repeat_interleave(torch.tensor([s[0] for s in specs], device=dev), counts)
    keep = torch.repeat_interleave(torch.tensor([float(s[1]) for s in specs], device=dev), counts)
    expo = torch.repeat_interleave(torch.tensor([s[2] for s in specs], device=dev), counts)
    base = torch.cat([t.reshape(-1).to(dev, torch.float32) for _, t in floats]) * keep
    flat = base + std * torch.randn(int(counts.sum()), generator=generator, device=dev)
    flat = torch.where(expo, torch.exp(flat), flat)
    out = {n: t.clone() for n, t in sd.items() if not t.is_floating_point()}
    for (n, t), piece in zip(floats, flat.split([t.numel() for _, t in floats])):
        out[n] = piece.view(t.shape)
    return out
