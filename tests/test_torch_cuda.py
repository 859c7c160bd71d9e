"""PyTorch port on the card: the CUDA mLSTM forward kernel against its plain
twin, and the model's kernel path against its plain path. These need a CUDA
device and nvcc; without a card they skip. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: the suite's conftest.py imports JAX, which the card machine
need not have.)
"""
import pytest
import torch

from xlstm_hved_torch.models import find_model_using_name
from xlstm_hved_torch.ops import mlstm_cuda
from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, NH, S, DH, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, NH, S, DH, generator=g, device=dev) for _ in range(3))
    ig = 0.5 * torch.randn(B, NH, S, generator=g, device=dev)
    fg = 3.0 + 3.0 * torch.rand(B, NH, S, generator=g, device=dev)
    return q, k, v, ig, fg


@pytest.mark.parametrize("B,NH,S,DH,L", [(1, 4, 4096, 16, 128), (1, 4, 6144, 16, 128),
                                         (2, 4, 1000, 8, 128), (1, 2, 97, 16, 32)])
def test_kernel_matches_twin(dev, B, NH, S, DH, L):
    prepared = mlstm_cuda.prepare(*_inputs(dev, B, NH, S, DH), L)
    out = mlstm_cuda.run_kernel(*prepared)
    ref = mlstm_cuda.mlstm_forward_reference(*prepared)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    assert err <= 5e-4 and err / float(ref.abs().max()) <= 2e-5  # as chip_smoke.py


def test_mlstm_forward_matches_chunkwise_and_counts(dev):
    q, k, v, ig, fg = _inputs(dev, 1, 4, 300, 16, seed=1)
    before = mlstm_cuda.run_kernel.launches
    with torch.no_grad():
        out = mlstm_cuda.mlstm_forward(q, k, v, ig, fg, chunk_size=128)
    assert mlstm_cuda.run_kernel.launches == before + 1
    ref = mlstm_chunkwise(q, k, v, ig, fg, chunk_size=128)
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=2e-4)
    with pytest.raises(RuntimeError, match="backward"):
        mlstm_cuda.mlstm_forward(q.requires_grad_(True), k, v, ig, fg)


def test_model_kernel_path_matches_plain_path(dev):
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=3)
    plain = find_model_using_name("XLSTM_HVED", device=dev, seed=3, mlstm_kernel=False)
    plain.load_state_dict(model.state_dict())
    x = torch.rand(1, 4, 32, 32, 32, generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev)
    before = mlstm_cuda.run_kernel.launches
    with torch.inference_mode():
        out = model(x, recon=True, deterministic=True)
        assert mlstm_cuda.run_kernel.launches == before + 1
        ref = plain(x, recon=True, deterministic=True)
    assert float((out.seg - ref.seg).abs().max()) <= 1e-3
    assert float((out.recon - ref.recon).abs().max()) <= 3.5e-3
