"""PyTorch port: the plain mLSTMs and the CUDA kernel's plain twin against
the JAX package (chunkwise scan and the Pallas kernel in interpret mode).
Tolerances are those of tests/test_mlstm.py for the Pallas kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (TF32 off)
from xlstm_hved_tpu.ops.mlstm import mlstm_chunkwise as j_chunkwise
from xlstm_hved_tpu.ops.mlstm_pallas import mlstm_pallas
from xlstm_hved_torch.nn.vil import MatrixLSTMCell
from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise, mlstm_quadratic
from xlstm_hved_torch.ops.mlstm_cuda import (mlstm_forward, mlstm_forward_reference,
                                             prepare)

ATOL, RTOL = 2e-4, 1e-3


def _inputs(seed, B=1, NH=2, S=80, DH=16, case="realistic"):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, NH, S, DH).astype(np.float32) for _ in range(3))
    ig = (0.5 * rng.randn(B, NH, S)).astype(np.float32)
    fg = (3.0 + 3.0 * rng.rand(B, NH, S)).astype(np.float32)
    if case == "extreme":          # fast decay, large input gates
        ig, fg = ig * 10.0, fg - 12.0
    elif case == "wide_igate":     # igate ramp 0..200 inside one chunk
        ig = np.broadcast_to(np.linspace(0.0, 200.0, S, dtype=np.float32), ig.shape).copy()
    elif case == "deep_forget":    # m_t far below -60: the clamped normaliser
        ig, fg = ig - 100.0, fg - 20.0
    return q, k, v, ig, fg


def _twin(q, k, v, ig, fg, L):
    B, NH, S, DH = q.shape
    out = mlstm_forward_reference(*prepare(*map(torch.from_numpy, (q, k, v, ig, fg)), L))
    return out.reshape(B, NH, -1, DH)[:, :, :S].numpy()


CASES = [
    (80, 32, "realistic"),
    (97, 32, "realistic"),
    (130, 64, "realistic"),
    (256, 64, "realistic"),     # several full chunks
    (80, 16, "extreme"),
    (64, 64, "wide_igate"),
    (64, 16, "wide_igate"),
    (48, 16, "deep_forget"),
]


@pytest.mark.parametrize("S,L,case", CASES)
def test_chunkwise_matches_jax(S, L, case):
    q, k, v, ig, fg = _inputs(S, S=S, case=case)
    ref = np.asarray(j_chunkwise(*map(jnp.asarray, (q, k, v, ig, fg)), chunk_size=L))
    out = mlstm_chunkwise(*map(torch.from_numpy, (q, k, v, ig, fg)), chunk_size=L)
    assert np.all(np.isfinite(out.numpy()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S,case", [(80, "realistic"), (97, "realistic"),
                                    (80, "extreme"), (64, "wide_igate")])
def test_quadratic_matches_jax_chunkwise(S, case):
    q, k, v, ig, fg = _inputs(S + 1, S=S, case=case)
    ref = np.asarray(j_chunkwise(*map(jnp.asarray, (q, k, v, ig, fg)), chunk_size=32))
    out = mlstm_quadratic(*map(torch.from_numpy, (q, k, v, ig, fg)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S,L,case", [c for c in CASES if c[0] <= 130])
def test_kernel_twin_matches_pallas_interpret(S, L, case):
    q, k, v, ig, fg = _inputs(S + 2, S=S, case=case)
    ref = np.asarray(mlstm_pallas(*map(jnp.asarray, (q, k, v, ig, fg)), L, 1e-6, True))
    out = _twin(q, k, v, ig, fg, L)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_kernel_twin_prepare_pads_like_pallas():
    q, k, v, ig, fg = _inputs(5, B=2, NH=3, S=97)
    qf, kf, vf, a, s, cm = prepare(*map(torch.from_numpy, (q, k, v, ig, fg)), 32)
    assert qf.shape == (6, 128, 16) and a.shape == (6, 4, 32)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in (qf, kf, vf, a, s, cm))
    # padded tail: zero q/k/v, igate -1e30, no forget-gate decay
    assert torch.count_nonzero(qf[:, 97:]) == 0
    torch.testing.assert_close(a[:, -1, 1:], a[:, -1, 1:2].expand(-1, 31))
    assert float(s[:, -1, 1:].max()) < -1e29
    torch.testing.assert_close(cm, torch.cummax(s, dim=-1).values, rtol=0, atol=0)


def test_kernel_wrapper_refuses_what_it_cannot_run():
    q, k, v, ig, fg = map(torch.from_numpy, _inputs(6, S=64))
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_forward(q, k, v, ig, fg)                     # CPU tensors
    with pytest.raises(RuntimeError, match="backward"):
        mlstm_forward(q.clone().requires_grad_(True), k, v, ig, fg)
    q8, k8, v8 = (t[..., :12] for t in (q, k, v))
    with pytest.raises(ValueError, match="head width"):
        mlstm_forward(q8, k8, v8, ig, fg)
    with pytest.raises(ValueError, match="chunk_size"):
        mlstm_forward(q, k, v, ig, fg, chunk_size=256)


def test_matrix_lstm_cell_dispatch_on_cpu():
    cell = MatrixLSTMCell(32, 4, chunk_size=16)
    x = torch.randn(1, 40, 32)
    with torch.no_grad():
        h = cell(x, x, x)
    assert h.shape == (1, 40, 32) and torch.isfinite(h).all()
    cell.mlstm_kernel = True  # asking for the kernel on CPU tensors raises
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        cell(x, x, x)
