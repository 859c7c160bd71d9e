"""PyTorch port: the Vision-LSTM family (`xlstm_hved_torch/models/vision_lstm.py`)
against the JAX package's `models/vision_lstm.py`.

- `interpolate_sincos` against `jax.image.resize(method="cubic")` (the Keys
  kernel with a = -0.5, weights renormalised at the edges, antialiased when
  an axis shrinks) on growing, shrinking and mixed 2-D and 3-D grids, max|d|
  <= 1e-5 on values of order 1 (fp32 sums in another order); torch's own
  bicubic mode is shown to be another function.
- VisionLSTM (2-D, its position embedding resampled when the input grid is
  not the train-time one), VisionLSTM3D, ViL3DPatchEncoder and
  VisionLSTMEncoder with the flat position embedding: forwards on the same
  numpy-drawn weights (tests/_torch_port.py) carried across by
  `params_from_jax`, on JAX's CPU path, fp32, depth 2 (so one reversed
  block). Bound: max|d| <= 1e-4 * max(1, max|ref|); the largest seen is
  3.2e-6 on maps of 4.9.
- bf16 (`dtype`, cast at the op as flax's `dtype=`): VisionLSTM3D's bf16
  logits against JAX's bf16 logits within twice JAX's own bf16-vs-fp32
  distance on the same weights and input (the yardstick of the flagship's
  bf16 tests; measured 1.01 of that distance, 0.0195 against 0.0193).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_port as tp
from xlstm_hved_tpu.models import vision_lstm as jv
from xlstm_hved_torch.models import vision_lstm as tv

FWD_SCALED = 1e-4
RESIZE_ATOL = 1e-5


@pytest.mark.parametrize("grid_in,grid_out", [
    ((4, 4), (7, 9)),          # grow
    ((14, 14), (8, 5)),        # shrink: the kernel widens (antialiasing)
    ((6, 10), (12, 4)),        # one axis each way
    ((5, 5), (5, 8)),          # one axis unchanged
    ((4, 4, 4), (8, 6, 3)),    # 3-D
])
def test_interpolate_sincos_matches_jax_image_resize(grid_in, grid_out):
    embed = np.random.RandomState(0).randn(1, *grid_in, 6).astype(np.float32)
    want = np.asarray(jv.interpolate_sincos(jnp.asarray(embed), grid_out))
    got = tv.interpolate_sincos(torch.from_numpy(embed), grid_out).numpy()
    assert got.shape == want.shape == (1, *grid_out, 6)
    assert tp.max_abs(got, want) <= RESIZE_ATOL


def test_torch_bicubic_is_another_function():
    """F.interpolate's bicubic (a = -0.75, clamped edges) is not JAX's cubic:
    the port does not use it."""
    embed = np.random.RandomState(1).randn(1, 4, 4, 6).astype(np.float32)
    want = np.asarray(jv.interpolate_sincos(jnp.asarray(embed), (9, 9)))
    torch_bicubic = F.interpolate(torch.from_numpy(embed).permute(0, 3, 1, 2), size=(9, 9),
                                  mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    assert tp.max_abs(torch_bicubic.numpy(), want) > 1e-2


def _check_forward(jm, tm, x, seed=3):
    variables = tp.random_variables(jm, jnp.asarray(x), seed=seed)
    tp.load_port(tm, variables)
    want = jax.jit(jm.apply)(tp.to_jax(variables), jnp.asarray(x))
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    with torch.no_grad():
        got = tm(tp.ncdhw(x))
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if g.dim() == 2 else tp.ndhwc(g)
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert g.shape == w.shape and tp.max_abs(g, w) <= FWD_SCALED * scale
    return variables


@pytest.mark.parametrize("size,pos_grid", [((16, 16), None), ((16, 16), (2, 3)),
                                           ((20, 12), None)])
def test_vision_lstm_matches_jax(size, pos_grid):
    """(2, 3): the position embedding is stored on another grid than the
    input's (4 x 4) and resampled on the way in."""
    x = np.random.RandomState(0).rand(2, *size, 3).astype(np.float32)
    kw = dict(dim=16, depth=2, num_classes=5, patch_size=4, pos_grid=pos_grid)
    jm, tm = jv.VisionLSTM(**kw), tv.VisionLSTM(**kw, img_size=size)
    variables = _check_forward(jm, tm, x)
    grid = pos_grid or tuple(s // 4 for s in size)
    assert variables["params"]["encoder"]["pos_embed_nd"]["embed"].shape == (1, *grid, 16)


def test_vision_lstm3d_matches_jax():
    x = np.random.RandomState(1).rand(2, 16, 16, 16, 1).astype(np.float32)
    kw = dict(dim=16, depth=2, num_classes=5, patch_size=4)
    _check_forward(jv.VisionLSTM3D(**kw), tv.VisionLSTM3D(**kw, in_channels=1,
                                                          img_size=(16, 16, 16)), x)


@pytest.mark.parametrize("dims,depths", [((8, 16), (1, 1)), ((8, 12, 16), (2, 1, 2))])
def test_vil3d_patch_encoder_matches_jax(dims, depths):
    x = np.random.RandomState(2).rand(1, 16, 16, 16, 2).astype(np.float32)
    _check_forward(jv.ViL3DPatchEncoder(dims=dims, depths=depths),
                   tv.ViL3DPatchEncoder(dims=dims, depths=depths, in_channels=2), x)


def test_vision_lstm_encoder_flat_pos_embed_matches_jax():
    tokens = np.random.RandomState(3).randn(2, 10, 16).astype(np.float32)
    jm = jv.VisionLSTMEncoder(dim=16, depth=2)
    tm = tv.VisionLSTMEncoder(dim=16, depth=2, num_tokens=10)
    variables = tp.random_variables(jm, jnp.asarray(tokens), seed=4)
    tp.load_port(tm, variables)
    want = np.asarray(jax.jit(jm.apply)(tp.to_jax(variables), jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    assert tp.max_abs(got, want) <= FWD_SCALED * max(1.0, float(np.abs(want).max()))


def test_bilateral_avg_matches_jax():
    x = np.random.RandomState(5).randn(3, 7, 4).astype(np.float32)
    np.testing.assert_array_equal(tv.bilateral_avg(torch.from_numpy(x)).numpy(),
                                  np.asarray(jv.bilateral_avg(jnp.asarray(x))))


def test_vision_lstm3d_bf16_matches_jax_bf16():
    x = np.random.RandomState(0).rand(2, 16, 16, 16, 1).astype(np.float32)
    kw = dict(dim=16, depth=2, num_classes=5, patch_size=4)
    j32, j16 = jv.VisionLSTM3D(**kw), jv.VisionLSTM3D(**kw, dtype=jnp.bfloat16)
    variables = tp.random_variables(j32, jnp.asarray(x), seed=3)
    jvars = tp.to_jax(variables)
    a32 = np.asarray(jax.jit(j32.apply)(jvars, jnp.asarray(x)), np.float32)
    a16 = jax.jit(j16.apply)(jvars, jnp.asarray(x))
    assert a16.dtype == jnp.bfloat16
    a16 = np.asarray(a16.astype(jnp.float32))
    tm = tv.VisionLSTM3D(**kw, in_channels=1, img_size=(16, 16, 16), dtype=torch.bfloat16)
    tp.load_port(tm, variables)
    with torch.no_grad():
        got = tm(tp.ncdhw(x))
    assert got.dtype == torch.bfloat16
    jax_distance = tp.max_abs(a16, a32)
    assert jax_distance > 0.0
    assert tp.max_abs(got.float().numpy(), a16) <= 2.0 * jax_distance
