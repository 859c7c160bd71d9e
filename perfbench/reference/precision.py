"""The precisions the plain reference computes its layers in.

The configurations state bfloat16 for every conv and dense layer, and keep
the ViL an fp32 island (TF32 left as the process has it). "float32" is the
reference itself: operands as they are, with TF32 off (`strict_fp32`).
"bfloat16" is the reference at the precision the configurations state:
each value a conv or dense layer outside the ViL takes or gives, and each
gradient through them, rounded to bfloat16 (the products and sums in fp32),
the ViL in fp32; the sweep measures the program's distance to the fp32
reference at its outputs in units of this one's. "float8" is the control of
the benchmark's correctness check, one step below the stated precision of
every layer: outside the ViL, in the recipe of fp8 training, each value a
conv or dense layer takes or gives (its input, its weight, its output)
rounded to float8 e4m3 with one scale per tensor (its largest magnitude at
448, e4m3's largest finite value), and each gradient that flows back
through those values rounded to float8 e5m2 the same way (largest finite
57344); in the ViL, each operand and result of its projections, conv and
mLSTM rounded to bfloat16; the products and sums themselves in fp32.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    return _Bf16.apply(t)


Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]
# (outside the ViL, inside it)
QUANTIZERS = {"float32": (None, None), "bfloat16": (bf16_round, None),
              "float8": (fp8_round, bf16_round)}


def quantizer(name: str) -> Tuple[Rounding, Rounding]:
    """The roundings of a precision: (the convs and dense layers outside the
    ViL, the ViL's own)."""
    if name not in QUANTIZERS:
        raise ValueError(f"precision {name!r}: expected one of {sorted(QUANTIZERS)}")
    return QUANTIZERS[name]


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for matmuls and cuDNN convs while the block runs, then the
    process's settings as they were."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
