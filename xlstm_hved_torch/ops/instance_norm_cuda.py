"""The UxLSTM residual blocks' affine instance norm, fused with the residual
add and LeakyReLU: the kernel, its plain twin and the autograd Function.

`instance_norm_act(x, weight, bias, eps, residual)` is

    y = leaky_relu((x - mean) * rsqrt(var + eps) * weight + bias [+ residual])

over x (B, C, *spatial), with fp32 statistics per (sample, channel) (the
centred variance), LeakyReLU's slope 0.01, y in x's dtype. For CUDA tensors
it runs `InstanceNormActFunction`: two launches of `csrc/instance_norm.cu`
forward (the statistics, then the normalisation, affine, residual and
activation in one pass, fp32 arithmetic, y rounded once) and two backward,
on bf16 or fp32 maps. The kernel replaces no Pallas kernel: the JAX
package leaves this norm to XLA. CPU tensors run the plain twin
`instance_norm_act_reference`, the composed expression the module had
before the kernel, bit for bit. Nothing falls back on the card: CPU tensors
given to the kernel wrappers, shapes or dtypes they do not take (fp16 and
fp64 among them) and a failed build or launch raise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from xlstm_hved_torch.nn.blocks import at_least_fp32, leaky_relu
from xlstm_hved_torch.utils import cuda_build

SOURCES = ("instance_norm",)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library():
    """The library with its functions declared (it builds on first use)."""
    lib = cuda_build.load(SOURCES[0])
    lib.instance_norm_partials.argtypes = [_LONG, _INT, _INT]
    lib.instance_norm_partials.restype = _LONG
    lib.instance_norm_forward.argtypes = ([_PTR] * 8 + [_LONG, _INT, _INT, ctypes.c_float,
                                                        _INT, _INT, _PTR])
    lib.instance_norm_forward.restype = _INT
    lib.instance_norm_backward.argtypes = [_PTR] * 11 + [_LONG] + [_INT] * 4 + [_PTR]
    lib.instance_norm_backward.restype = _INT
    lib.instance_norm_error_string.argtypes = [_INT]
    lib.instance_norm_error_string.restype = ctypes.c_char_p
    return lib


def instance_norm_act_reference(x, weight, bias, eps: float = 1e-5, residual=None):
    """The plain twin: fp32 statistics (x's dtype if wider), the centred
    variance, the affine in that precision, rounded to x's dtype; then the
    residual added and LeakyReLU(0.01), each in x's dtype."""
    dims = tuple(range(2, x.ndim))
    x32 = at_least_fp32(x)
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = (y * weight.view(shape) + bias.view(shape)).to(x.dtype)
    if residual is not None:
        y = y + residual
    return leaky_relu(y)


def _check(x, weight, residual=None):
    """Raise unless the kernel takes these operands."""
    if x.dim() < 3 or weight.dim() != 1 or weight.shape[0] != x.shape[1]:
        raise ValueError(f"instance_norm takes x (B, C, *spatial) and a weight and bias of "
                         f"(C,); got {tuple(x.shape)}, {tuple(weight.shape)}")
    if x.dtype not in DTYPES or weight.dtype != torch.float32:
        raise ValueError(f"instance_norm takes x in bf16 or fp32 and an fp32 weight and bias; "
                         f"got {x.dtype}, {weight.dtype}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"instance_norm takes a residual of x's shape and dtype; got "
                         f"{tuple(residual.shape)} {residual.dtype} for {tuple(x.shape)} "
                         f"{x.dtype}")
    tensors = [x, weight] + ([] if residual is None else [residual])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("instance_norm takes contiguous tensors")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"instance_norm takes CUDA tensors on one device; got "
                         f"{[str(t.device) for t in tensors]}")


def _geometry(lib, x):
    """(voxels, batch, channels, scratch for the partials)."""
    n = math.prod(x.shape[2:])
    batch, channels = x.shape[:2]
    count = lib.instance_norm_partials(n, batch, channels)
    if count < 0:
        raise ValueError(f"instance_norm takes fewer than 2^31 voxels a channel and grids under "
                         f"2^31 blocks; got {tuple(x.shape)}")
    return n, batch, channels, torch.empty(2 * count, dtype=torch.float32, device=x.device)


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"instance_norm_{what} failed: "
                           f"{lib.instance_norm_error_string(rc).decode()} (code {rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def run_forward(x, weight, bias, eps: float = 1e-5, residual=None):
    """Two launches on CUDA tensors: x (B, C, *spatial) in bf16 or fp32,
    weight and bias (C,) fp32, an optional residual of x's shape and dtype,
    all contiguous. Returns (y in x's dtype, mean, rstd), the statistics
    (B, C) fp32. Adds one to `run_forward.calls`."""
    _check(x, weight, residual)
    _check(x, bias)
    lib = _library()
    n, batch, channels, part = _geometry(lib, x)
    y = torch.empty_like(x)
    mean = x.new_empty((batch, channels), dtype=torch.float32)
    rstd = torch.empty_like(mean)
    dev = x.device
    rc = lib.instance_norm_forward(
        x.data_ptr(), _ptr(residual), weight.data_ptr(), bias.data_ptr(), part.data_ptr(),
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, batch, channels, eps,
        DTYPES[x.dtype], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "forward")
    run_forward.calls += 1
    return y, mean, rstd


def run_backward(dy, y, x, weight, mean, rstd, residual: bool = False):
    """Two launches on CUDA tensors: the upstream gradient dy, the forward's
    y and x, its weight and statistics. Returns (dx, the residual's gradient
    or None, dweight, dbias). Adds one to `run_backward.calls`."""
    for t in (dy, y):
        _check(x, weight, t)
    lib = _library()
    n, batch, channels, part = _geometry(lib, x)
    if mean.shape != (batch, channels) or rstd.shape != mean.shape:
        raise ValueError(f"instance_norm's statistics are ({batch}, {channels}); got "
                         f"{tuple(mean.shape)}, {tuple(rstd.shape)}")
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual else None
    dweight, dbias = torch.empty_like(weight), torch.empty_like(weight)
    dev = x.device
    rc = lib.instance_norm_backward(
        dy.data_ptr(), y.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), part.data_ptr(), dx.data_ptr(), _ptr(dres), dweight.data_ptr(),
        dbias.data_ptr(), n, batch, channels, DTYPES[x.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "backward")
    run_backward.calls += 1
    return dx, dres, dweight, dbias


# Calls of the wrappers since the counts were last set to 0; a call is two
# CUDA launches. A forward of a UxLSTM net adds 2 to `run_forward.calls` per
# residual block, its backward as many to `run_backward.calls`.
run_forward.calls = 0
run_backward.calls = 0


class InstanceNormActFunction(torch.autograd.Function):
    """The kernel forward and backward. Saves x, y (the next layer's input,
    kept anyway), the weight and the fp32 statistics: no fp32 copy of a map,
    and not the residual (its gradient is the activation's)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, eps):
        y, mean, rstd = run_forward(x, weight, bias, eps, residual)
        ctx.save_for_backward(x, y, weight, mean, rstd)
        ctx.residual = residual is not None
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, y, weight, mean, rstd = ctx.saved_tensors
        dx, dres, dweight, dbias = run_backward(dy.contiguous(), y, x, weight, mean, rstd,
                                                ctx.residual)
        return dx, dweight, dbias, dres, None


def instance_norm_act(x, weight, bias, eps: float = 1e-5, residual=None):
    """The fused norm: the kernel for CUDA tensors (differentiable; it
    raises on dtypes it does not take), the plain twin for CPU tensors."""
    if x.device.type == "cuda":
        return InstanceNormActFunction.apply(
            x.contiguous(), weight, bias, None if residual is None else residual.contiguous(),
            eps)
    return instance_norm_act_reference(x, weight, bias, eps, residual)
