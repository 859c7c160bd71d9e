"""Warm-up learning-rate schedules and the largest patch the card runs (the
port's own copy of `xlstm_hved_tpu/utils/schedules.py`).

The warm-ups wrap a base schedule, a callable from the step to a value, and
return one too; a schedule of multipliers (base 1) goes straight into
`torch.optim.lr_scheduler.LambdaLR`.

`find_maximum_patch_size` runs a forward at each patch shape in turn and
keeps the last that fits. It stops at the first shape that runs out of
device memory, and only there: the JAX function stops at any exception,
which would report a failed build or launch as a patch size. Here those
propagate.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch


def linear_warmup(base_schedule: Callable, warmup_steps: int) -> Callable:
    """step -> min(1, (step + 1) / warmup_steps) * base_schedule(step)."""

    def schedule(step):
        return min(1.0, (step + 1.0) / max(warmup_steps, 1)) * base_schedule(step)

    return schedule


def exponential_warmup(base_schedule: Callable, warmup_period: int) -> Callable:
    """step -> (1 - exp(-(step + 1) / warmup_period)) * base_schedule(step)."""

    def schedule(step):
        return (1.0 - math.exp(-(step + 1.0) / max(warmup_period, 1))) * base_schedule(step)

    return schedule


DEFAULT_PATCH_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (64, 128, 128), (96, 128, 128),
    (64, 160, 160), (96, 160, 160),
    (64, 192, 192), (96, 192, 192),
    (128, 192, 128),
)


def find_maximum_patch_size(forward: Callable[[torch.Tensor], object], in_channels: int = 4,
                            patch_shapes: Sequence[Tuple[int, int, int]] = DEFAULT_PATCH_SHAPES,
                            device="cuda") -> Optional[Tuple[int, int, int]]:
    """The last of `patch_shapes` (tried in order) at which `forward` runs
    on a zero (1, in_channels, D, H, W) input on `device`, or None when the
    first already runs out of memory. `forward(x)` must run the work to be
    sized; it is synchronised before the next shape. Only
    torch.cuda.OutOfMemoryError ends the probe; any other error is raised."""
    device = torch.device(device)
    best = None
    for shape in patch_shapes:
        x = torch.zeros((1, in_channels, *shape), device=device)
        try:
            forward(x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except torch.cuda.OutOfMemoryError:
            print(f"patch {tuple(shape)}: out of device memory")
            break
        finally:
            del x
            if device.type == "cuda":
                torch.cuda.empty_cache()
        best = tuple(shape)
    return best
