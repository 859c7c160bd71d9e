"""PyTorch port: the warm-up schedules and the patch-size probe
(`utils/schedules.py`).

The warm-ups against the JAX schedules for steps 0-25, on a constant base
(JAX's own test, tests/test_ops.py) and on a poly base, to fp32 rounding
(JAX computes in fp32, the port in Python floats); as LambdaLR multipliers.
`find_maximum_patch_size` keeps the last shape its forward ran at and stops
at the first out-of-memory error; any other error propagates (the JAX
function stops at any exception).
"""
import numpy as np
import pytest
import torch

from xlstm_hved_tpu.utils import schedules as jsched
from xlstm_hved_torch.utils import schedules as tsched


def _poly(step):
    return 1e-4 * (1.0 - step / 40.0) ** 0.9


@pytest.mark.parametrize("kind", ["linear_warmup", "exponential_warmup"])
@pytest.mark.parametrize("base", [lambda step: 1.0, _poly], ids=["constant", "poly"])
@pytest.mark.parametrize("period", [1, 10])
def test_warmups_match_jax(kind, base, period):
    got = getattr(tsched, kind)(base, period)
    want = getattr(jsched, kind)(base, period)
    for step in range(26):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-7, err_msg=str(step))
    if kind == "linear_warmup":
        assert got(period - 1) == base(period - 1) and got(100) == base(100)
    else:   # the multiplier rises towards 1
        omega = [got(step) / base(step) for step in (0, 5, 25)]
        assert 0 < omega[0] < omega[1] < omega[2] <= 1.0


def test_warmup_drives_lambda_lr():
    param = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([param], lr=0.5)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, tsched.linear_warmup(lambda s: 1.0, 4))
    lrs = []
    for _ in range(6):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [0.125, 0.25, 0.375, 0.5, 0.5, 0.5])


def _forward(fail_at, error):
    seen = []

    def forward(x):
        seen.append(tuple(x.shape[2:]))
        assert x.shape[:2] == (1, 4) and not x.any()
        if len(seen) == fail_at:
            raise error
        return x.sum()

    return forward, seen


def test_patch_probe_stops_at_the_first_out_of_memory():
    shapes = tsched.DEFAULT_PATCH_SHAPES
    assert shapes == jsched.DEFAULT_PATCH_SHAPES
    forward, seen = _forward(3, torch.cuda.OutOfMemoryError("out of memory"))
    assert tsched.find_maximum_patch_size(forward, device="cpu") == shapes[1]
    assert seen == list(shapes[:3])
    forward, _ = _forward(1, torch.cuda.OutOfMemoryError("out of memory"))
    assert tsched.find_maximum_patch_size(forward, device="cpu") is None
    forward, seen = _forward(99, None)
    assert tsched.find_maximum_patch_size(forward, 4, shapes[:2], "cpu") == shapes[1]


def test_patch_probe_raises_any_other_error():
    forward, seen = _forward(2, RuntimeError("CUDA error: an illegal memory access"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tsched.find_maximum_patch_size(forward, device="cpu")
    assert len(seen) == 2
