"""PyTorch port: the RSM gates' thin 7^3 conv (`ops/gate_cuda.py`). On CPU
tensors `gate_conv` is the plain twin, bit for bit the F.conv3d expression
the gate ran before the kernel, at the cells' channel counts and
AttenModule's, in bf16, fp32 and fp64, at odd sizes and batch 2, and counts
no kernel launch; `_composed_pool_gate` gives the same bits as that
expression on the folded weights. The kernel wrapper refuses what it does
not take before it looks for a card: CPU tensors, channel counts, kernel
sizes and dtypes outside the kernel's. The kernel itself is held to the
twin on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3)."""
import pytest
import torch
import torch.nn.functional as F

from xlstm_hved_torch.nn import blocks
from xlstm_hved_torch.ops import gate_cuda

DTYPES = (torch.bfloat16, torch.float32, torch.float64)


def _operands(n, cin, cout, shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, *shape, generator=gen).to(dtype)
    w = (0.05 * torch.randn(cout, cin, 7, 7, 7, generator=gen)).to(dtype)
    b = (0.1 * torch.randn(cout, generator=gen)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("cin,cout", [(2, 1), (4, 1), (10, 4)])
def test_cpu_gate_conv_is_the_f_conv3d_expression(cin, cout, dtype):
    x, w, b = _operands(2, cin, cout, (9, 13, 11), dtype)
    before = gate_cuda.run_gate_kernel.launches
    out = gate_cuda.gate_conv(x, w, b)
    assert torch.equal(out, F.conv3d(x, w, b, padding=3))
    assert out.dtype == dtype and out.shape == (2, cout, 9, 13, 11)
    assert gate_cuda.run_gate_kernel.launches == before


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_composed_gate_on_cpu_is_the_folded_conv(dtype):
    """AttenModule2's enc gate (4 -> 16 grouped 7^3, then 16 -> 1) through
    `_composed_pool_gate` equals the fold and the F.conv3d line written out,
    with its gradients, and launches nothing."""
    torch.manual_seed(3)
    grouped, point = blocks.conv3d(4, 16, 7, groups=4), blocks.conv3d(16, 1, 1)
    grouped.compute_dtype = dtype
    x = torch.rand(2, 4, 9, 13, 11, requires_grad=True)
    before = gate_cuda.run_gate_kernel.launches
    got = blocks._composed_pool_gate(x, grouped, point)
    w7 = grouped.weight.reshape(4, 4, 7, 7, 7)
    w1 = point.weight.reshape(1, 4, 4)
    k_eff = torch.einsum("mekij,ome->omkij", w7, w1)
    b_eff = torch.einsum("me,ome->o", grouped.bias.reshape(4, 4), w1) + point.bias
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    want = F.conv3d(cast(x), cast(k_eff), cast(b_eff), padding=3)
    assert torch.equal(got, want)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(4)).to(want.dtype)
    leaves = (x, grouped.weight, grouped.bias, point.weight, point.bias)
    for a, e in zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, leaves, g)):
        assert torch.equal(a, e)
    assert gate_cuda.run_gate_kernel.launches == before


def test_an_atten_module2_forward_on_cpu_launches_no_kernel():
    module = blocks.AttenModule2()
    seg, enc = torch.rand(1, 4, 8, 8, 8), torch.rand(1, 4, 8, 8, 8)
    before = gate_cuda.run_gate_kernel.launches
    out = module(seg, enc)
    assert out.shape == (1, 8, 8, 8, 8) and torch.isfinite(out).all()
    assert gate_cuda.run_gate_kernel.launches == before


@pytest.mark.parametrize("case", ["cpu", "in_channels", "out_channels", "kernel", "dtype",
                                  "mixed", "bias"])
def test_the_kernel_wrapper_refuses_what_it_does_not_take(case):
    shapes = {"in_channels": (17, 1), "out_channels": (4, 5)}
    cin, cout = shapes.get(case, (4, 1))
    x, w, b = _operands(1, cin, cout, (8, 8, 8), torch.float32)
    if case == "kernel":
        w = w[..., 1:-1, 1:-1, 1:-1].contiguous()
    elif case == "dtype":
        x, w, b = x.half(), w.half(), b.half()
    elif case == "mixed":
        w = w.double()
    elif case == "bias":
        b = None
    match = "CUDA tensors" if case == "cpu" else "gate_conv takes"
    before = gate_cuda.run_gate_kernel.launches
    with pytest.raises(ValueError, match=match):
        gate_cuda.run_gate_kernel(x, w, b)
    assert gate_cuda.run_gate_kernel.launches == before
