"""The RSM gates' thin 7^3 conv on the card: the kernel, its plain twin and
the autograd Function.

`nn/blocks.py::_composed_pool_gate` folds each AttenModule2 / AttenModule
gate (a grouped 7^3 conv, then a 1x1 conv) into one conv of 2 to 10 input
channels and 1 to 4 output channels, with "same" padding and a bias per
output channel. On the card cuDNN runs that shape on its legacy fp32 path,
far from the card's arithmetic rate, so `run_gate_kernel` runs it as one
launch of `gate_conv` (`csrc/gate_conv.cu`, which replaces no Pallas kernel:
the JAX package leaves this conv to XLA). Its operands are the gate's
compute dtype: bf16 (fp32 sums), fp32 (fp32 sums, no TF32) or fp64.

`gate_conv` is the entry point: `GateConvFunction` (forward: the kernel;
backward: `aten.convolution_backward` with the arguments autograd passes for
F.conv3d, so the gradients are those of the library call) for CUDA tensors,
the plain twin `gate_conv_reference` (the F.conv3d expression) for CPU
tensors. The kernel wrapper never falls back: CPU tensors, shapes or dtypes
it does not take and a failed build or launch raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from xlstm_hved_torch.utils import cuda_build

SOURCES = ("gate_conv",)
KERNEL_SIZE = 7
MAX_IN, MAX_OUT = 16, 4
DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    """The ctypes launch function and the library's error-string getter,
    declared once (the library builds on first use)."""
    lib = cuda_build.load(SOURCES[0])
    fn = lib.gate_conv_launch
    fn.argtypes = [_PTR] * 4 + [_INT] * 9 + [_PTR]
    fn.restype = _INT
    error_string = lib.gate_conv_error_string
    error_string.argtypes = [_INT]
    error_string.restype = ctypes.c_char_p
    return fn, error_string


def gate_conv_reference(x, weight, bias):
    """The plain twin: the gate's conv as one F.conv3d, "same" padding."""
    return F.conv3d(x, weight, bias, padding=weight.shape[-1] // 2)


def _check(x, weight, bias):
    """Raise unless the kernel takes these operands (the device apart)."""
    if x.dim() != 5 or weight.dim() != 5 or bias is None or bias.dim() != 1:
        raise ValueError(f"gate_conv takes x (N, C, D, H, W), a weight (O, C, k, k, k) and a "
                         f"bias (O,); got {tuple(x.shape)}, {tuple(weight.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")
    out_ch, in_ch, *k = weight.shape
    if (k != [KERNEL_SIZE] * 3 or x.shape[1] != in_ch or bias.shape[0] != out_ch
            or not 1 <= in_ch <= MAX_IN or not 1 <= out_ch <= MAX_OUT):
        raise ValueError(f"gate_conv takes a {KERNEL_SIZE}^3 weight of 1..{MAX_IN} input and "
                         f"1..{MAX_OUT} output channels matching x and the bias; got x "
                         f"{tuple(x.shape)}, weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if x.dtype not in DTYPES or weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise ValueError(f"gate_conv takes bf16, fp32 or fp64 operands of one dtype; got "
                         f"{x.dtype}, {weight.dtype}, {bias.dtype}")


def run_gate_kernel(x, weight, bias):
    """One launch of `gate_conv` on CUDA tensors: x (N, C, D, H, W), weight
    (O, C, 7, 7, 7), bias (O,), one dtype, made contiguous. Returns (N, O,
    D, H, W) in that dtype. Adds one to `run_gate_kernel.launches`."""
    _check(x, weight, bias)
    dev = x.device
    if dev.type != "cuda" or weight.device != dev or bias.device != dev:
        raise ValueError(f"gate_conv takes CUDA tensors on one device; got {x.device}, "
                         f"{weight.device}, {bias.device}")
    x, weight, bias = x.contiguous(), weight.contiguous(), bias.contiguous()
    n, c, d, h, w = x.shape
    out = x.new_empty((n, weight.shape[0], d, h, w))
    fn, error_string = _launcher()
    rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c,
            weight.shape[0], d, h, w, KERNEL_SIZE, DTYPES[x.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gate_conv_launch failed: {error_string(rc).decode()} (code {rc})")
    run_gate_kernel.launches += 1
    return out


# Calls of the wrapper since the count was last set to 0 (read by
# chip_smoke.py); one call is one CUDA launch. A 15-subset sweep of an
# AttenModule2 preset adds 90 (2 gates in each of 3 decoder stages), a
# flagship train step 12 (its two G forwards).
run_gate_kernel.launches = 0


class GateConvFunction(torch.autograd.Function):
    """The kernel forward; the backward of F.conv3d on the same saved
    operands (dgrad and wgrad as autograd computes them for the library
    call)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return run_gate_kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        pad = weight.shape[-1] // 2
        return torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]], [1, 1, 1], [pad, pad, pad], [1, 1, 1], False,
            [0, 0, 0], 1, list(ctx.needs_input_grad))


def gate_conv(x, weight, bias):
    """The gate's thin conv: the kernel for CUDA tensors (differentiable),
    the plain twin for CPU tensors. The device of x chooses."""
    if x.device.type == "cuda":
        return GateConvFunction.apply(x, weight, bias)
    return gate_conv_reference(x, weight, bias)
