"""PyTorch port: the UxLSTM residual blocks' fused instance norm
(`ops/instance_norm_cuda.py`) on the CPU. `ResBlockND` gives the same bits
as the composed expression it had before the fused op, in fp32 and bf16,
forward and backward; a UxLSTM forward opens the span `uxlstm.norm` once
per norm; the kernel wrappers raise on what the kernel does not take before
they build or launch anything; and the kernels' algebra (the statistics
merged chunk by chunk with Chan's formula, the backward from the sums of
dpre and dpre xhat, LeakyReLU's derivative from the sign of y) written out
in fp64 matches autograd through the plain twin. The kernel itself runs in
tests/test_torch_cuda.py."""
import pytest
import torch
import torch.nn.functional as F

from xlstm_hved_torch.models import UXlstmBot, UXlstmEnc
from xlstm_hved_torch.models.uxlstm import ResBlockND
from xlstm_hved_torch.nn.blocks import set_compute_dtype
from xlstm_hved_torch.ops import instance_norm_cuda as inc


def _old_norm(norm, x):
    """InstanceNormND.forward as it was before the fused op."""
    dims = tuple(range(2, x.ndim))
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x32 - mean) * torch.rsqrt(var + norm.eps)
    return (y * norm.weight.view(shape) + norm.bias.view(shape)).to(x.dtype)


def _old_block(block, x):
    """ResBlockND.forward as it was before the fused op."""
    y = F.leaky_relu(_old_norm(block.norm1, block.conv1(x)), negative_slope=1e-2)
    y = _old_norm(block.norm2, block.conv2(y))
    if block.conv3 is not None:
        x = block.conv3(x)
    return F.leaky_relu(y + x, negative_slope=1e-2)


@pytest.mark.parametrize("conv3", [True, False], ids=["conv3", "identity"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_resblock_on_the_cpu_is_bitwise_the_composed_block(dtype, ndim, conv3):
    torch.manual_seed(0)
    block = ResBlockND(ndim, 6, 6, 3, 1, conv3)
    with torch.no_grad():
        for norm in (block.norm1, block.norm2):
            norm.weight.add_(0.3 * torch.randn(6))
            norm.bias.add_(0.3 * torch.randn(6))
    set_compute_dtype(block, dtype if dtype != torch.float32 else None)
    x = torch.randn(2, 6, *(9, 7, 5)[:ndim]).to(dtype)
    g = torch.randn(2, 6, *(9, 7, 5)[:ndim]).to(dtype)
    runs = []
    for fn in (block, lambda t: _old_block(block, t)):
        leaf = x.clone().requires_grad_(True)
        block.zero_grad()
        out = fn(leaf)
        out.backward(g)
        runs.append([out.detach(), leaf.grad] + [p.grad.clone() for p in block.parameters()])
    for got, want in zip(*runs):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _profiled_ranges(fn, name):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.profiler.kineto_results.events() if e.name() == name]


@pytest.mark.parametrize("net", ["enc_3d", "bot_2d"])
def test_a_uxlstm_forward_opens_one_norm_span_per_norm(net):
    """Two `uxlstm.norm` spans per ResBlockND, whatever the net's shape."""
    torch.manual_seed(1)
    if net == "enc_3d":   # maps 16^3 .. 2^3, the last stage over channel tokens
        model = UXlstmEnc((16, 16, 16), 2, (4, 8, 16, 32), 2,
                          strides=((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
                          deep_supervision=True, chunk_size=16)
        x = torch.randn(1, 2, 16, 16, 16)
    else:
        model = UXlstmBot((16, 16), 2, (4, 8, 16), 2, strides=(1, 2, 2), chunk_size=16)
        x = torch.randn(1, 2, 16, 16)
    blocks = sum(isinstance(m, ResBlockND) for m in model.modules())
    with torch.no_grad():
        spans = _profiled_ranges(lambda: model(x), "uxlstm.norm")
    assert blocks >= 5 and len(spans) == 2 * blocks


def _operands(dtype=torch.bfloat16, shape=(2, 3, 4, 4, 4), device="cpu"):
    x = torch.randn(shape).to(device=device, dtype=dtype)
    return x, torch.ones(shape[1], device=device), torch.zeros(shape[1], device=device)


# case -> what the error names
REFUSED = {"cpu": "CUDA tensors", "fp64": "bf16 or fp32", "fp16": "bf16 or fp32",
           "weight_dtype": "bf16 or fp32", "not_contiguous": "contiguous",
           "rank": "spatial", "residual_dtype": "residual", "residual_shape": "residual"}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_kernel_wrapper_raises_on_what_it_does_not_take(case, monkeypatch):
    """Before any build or launch (the library is never loaded). The checks
    run in order: rank and widths, dtypes, the residual, contiguity, and
    the device last, so a CPU tensor reaches each case's own check."""
    monkeypatch.setattr(inc, "_library", lambda: pytest.fail("the library was loaded"))
    x, w, b = _operands()
    residual = None
    if case in ("fp64", "fp16"):
        x = x.to({"fp64": torch.float64, "fp16": torch.float16}[case])
    elif case == "not_contiguous":
        x = x.transpose(2, 4)
    elif case == "residual_dtype":
        residual = x.float()
    elif case == "residual_shape":
        residual = x[:, :, :2]
    elif case == "weight_dtype":
        w = w.double()
    elif case == "rank":
        x = x.flatten(1)
    with pytest.raises(ValueError, match=REFUSED[case]):
        inc.run_forward(x, w, b, residual=residual)
    if residual is None:
        with pytest.raises(ValueError, match=REFUSED[case]):
            inc.run_backward(x, x, x, w, torch.zeros(2, 3), torch.ones(2, 3), False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64], ids=str)
def test_the_cpu_takes_the_plain_twin(dtype, monkeypatch):
    monkeypatch.setattr(inc.InstanceNormActFunction, "apply",
                        lambda *a: pytest.fail("the kernel's Function on the CPU"))
    x, w, b = _operands(dtype)
    r = torch.randn_like(x)
    out = inc.instance_norm_act(x, w + 0.5, b - 0.5, 1e-5, r)
    assert torch.equal(out, inc.instance_norm_act_reference(x, w + 0.5, b - 0.5, 1e-5, r))


def _kernel_algebra(x, w, b, eps, r, dy, chunk):
    """The kernels' arithmetic written out on (B, C, n) in the dtype given:
    per-chunk mean and squared deviations merged in order with Chan's
    formula; y; the backward from A = sum dpre and Bv = sum dpre xhat, with
    dpre read from the sign of y."""
    B, C, n = x.shape
    cnt, mean, m2 = (torch.zeros(B, C, dtype=x.dtype) for _ in range(3))
    for k in range(0, n, chunk):
        part = x[..., k:k + chunk]
        nb = part.shape[-1]
        mb = part.mean(-1)
        m2b = (part - mb[..., None]).square().sum(-1)
        tot = cnt + nb
        d = mb - mean
        f = nb / tot
        mean, m2, cnt = mean + d * f, m2 + m2b + d * d * cnt * f, tot
    rstd = torch.rsqrt(m2 / n + eps)
    xhat = (x - mean[..., None]) * rstd[..., None]
    t = xhat * w[:, None] + b[:, None] + (0 if r is None else r)
    y = torch.where(t > 0, t, t * 1e-2)
    dpre = torch.where(y > 0, dy, dy * 1e-2)
    a, bv = dpre.sum(-1), (dpre * xhat).sum(-1)
    dx = (w[:, None] * rstd[..., None]) * (dpre - a[..., None] / n - xhat * bv[..., None] / n)
    return y, dx, dpre, bv.sum(0), a.sum(0)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 11, 13, 7), (2, 4, 9, 30)], ids=str)
def test_the_kernels_algebra_matches_autograd_through_the_twin(shape, residual):
    """A 3-D instance of 1001 values (eight chunks, the last one short) and
    a 2-D one of 270 (three)."""
    gen = torch.Generator().manual_seed(2)
    x = (3 + 2 * torch.randn(shape, generator=gen)).double()
    w = torch.randn(shape[1], generator=gen).double()
    b = torch.randn(shape[1], generator=gen).double()
    r = torch.randn(shape, generator=gen).double() if residual else None
    dy = torch.randn(shape, generator=gen).double()
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    rleaf = r.clone().requires_grad_(True) if residual else None
    out = inc.instance_norm_act_reference(*leaves, 1e-5, rleaf)
    out.backward(dy)
    flat = lambda t: t.flatten(2)   # noqa: E731
    y, dx, dres, dw, db = _kernel_algebra(flat(x), w, b, 1e-5, None if r is None else flat(r),
                                          flat(dy), chunk=128)
    pairs = [(y, flat(out.detach())), (dx, flat(leaves[0].grad)), (dw, leaves[1].grad),
             (db, leaves[2].grad)]
    if residual:
        pairs.append((dres, flat(rleaf.grad)))
    for got, want in pairs:
        assert torch.allclose(got, want, rtol=1e-10, atol=1e-12)


# the C types of the entry points' parameters as ctypes declares them
C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "long long": "c_longlong",
           "int": "c_int", "float": "c_float"}


def test_the_ctypes_declarations_follow_the_c_entry_points(monkeypatch):
    """Each `extern "C"` function of csrc/instance_norm.cu is declared with
    its parameters' types in order (a missing or extra argument would only
    show as a TypeError on the card)."""
    import ctypes
    import os
    import re
    from types import SimpleNamespace

    from xlstm_hved_torch.utils import cuda_build

    src = open(os.path.join(os.path.dirname(inc.__file__), "..", "csrc",
                            "instance_norm.cu")).read()
    entries = dict(re.findall(r'extern "C" [\w\s\*]+?(instance_norm_\w+)\(([^)]*)\)', src))
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in entries})
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    inc._library.cache_clear()
    try:
        inc._library()
    finally:
        inc._library.cache_clear()
    assert set(entries) == {"instance_norm_partials", "instance_norm_forward",
                            "instance_norm_backward", "instance_norm_error_string"}
    for name, params in entries.items():
        want = [getattr(ctypes, C_TYPES[re.sub(r"\s*\w+$", "", p.strip())])
                for p in params.split(",")]
        assert getattr(lib, name).argtypes == want, name
    assert getattr(lib, "instance_norm_forward").restype is ctypes.c_int
