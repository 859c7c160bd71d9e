"""PyTorch port: each building block on the flagship path against its JAX
counterpart, same weights (converted by params_from_jax) and same input,
fp32, max abs error <= 1e-5. Inputs are NDHWC for JAX and NCDHW for the
port; the comparison moves the channel axis back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_port, max_abs, ncdhw, ndhwc, random_variables, to_jax
from xlstm_hved_tpu.nn import blocks as jb
from xlstm_hved_tpu.nn.dusfe import DuSEAttention as JDuSE
from xlstm_hved_tpu.nn.skr import SkrGate as JSkrGate
from xlstm_hved_tpu.nn.vil import DoubleConvViL as JDoubleConvViL
from xlstm_hved_tpu.nn.vil import ViLLayer3D as JViLLayer3D
from xlstm_hved_torch.nn import blocks as tb
from xlstm_hved_torch.nn.dusfe import DuSEAttention
from xlstm_hved_torch.nn.skr import SkrGate
from xlstm_hved_torch.nn.vil import DoubleConvViL, DropPath, ViLBlock, ViLLayer3D

ATOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _compare(jmod, tmod, inputs, jkw=None, atol=ATOL, seed=0):
    jkw = jkw or {}
    jin = [jnp.asarray(a) for a in inputs]
    variables = random_variables(jmod, *jin, seed=seed, **jkw)
    load_port(tmod, variables)
    j_out = jax.jit(lambda v, *a: jmod.apply(v, *a, **jkw))(to_jax(variables), *jin)
    with torch.no_grad():
        t_out = tmod(*[ncdhw(a) for a in inputs])
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    assert len(j_out) == len(t_out)
    for j, t in zip(j_out, t_out):
        assert ndhwc(t).shape == j.shape
        err = max_abs(ndhwc(t), j)
        assert err <= atol, err


@pytest.mark.parametrize("shape", [(1, 2, 2, 2, 8), (2, 8, 6, 4, 3)])
def test_instance_norm_matches_jax(shape):
    # level-3 DRB output at a 32^3 crop is only 2^3 voxels
    x = _rand(1, *shape, scale=3.0) + 5.0
    err = max_abs(ndhwc(tb.instance_norm(ncdhw(x))), jb.instance_norm(jnp.asarray(x)))
    assert err <= ATOL, err


@pytest.mark.parametrize("src", [(2, 2, 2), (4, 4, 4), (4, 6, 4), (8, 8, 8)])
def test_resize_trilinear_matches_jax_at_exact_x2(src):
    x = _rand(2, 1, *src, 3)
    size = tuple(2 * s for s in src)
    err = max_abs(ndhwc(tb.resize_trilinear(ncdhw(x), size)),
                  jb.resize_trilinear(jnp.asarray(x), size))
    assert err <= 1e-6, err


def test_max_pool3d_matches_jax():
    x = _rand(3, 1, 8, 6, 4, 5)
    np.testing.assert_array_equal(ndhwc(tb.max_pool3d(ncdhw(x))),
                                  np.asarray(jb.max_pool3d(jnp.asarray(x))))


def test_single_and_double_conv_match_jax():
    x = _rand(4, 1, 8, 8, 8, 6)
    _compare(jb.SingleConv(5, 3, 1, "ilc"), tb.SingleConv(6, 5, "ilc"), [x])
    _compare(jb.DoubleConv(8, encoder=True, order="ilc"),
             tb.DoubleConv(6, 8, encoder=True, order="ilc"), [x])
    _compare(jb.DoubleConv(4, encoder=False, order="ilc"),
             tb.DoubleConv(6, 4, encoder=False, order="ilc"), [x])


def test_basic_conv_pointwise_and_depthwise_match_jax():
    x = _rand(5, 1, 8, 8, 8, 4)
    _compare(jb.BasicConv(8, 1), tb.BasicConv(4, 8, 1), [x])          # VU 1x1
    _compare(jb.BasicConv(4, 3, groups=4), tb.BasicConv(4, 4, 3, groups=4), [x])


def test_encoder_stage_matches_jax():
    x = _rand(6, 1, 8, 8, 8, 4)
    _compare(jb.EncoderStage(8, order="ilc"), tb.EncoderStage(4, 8, order="ilc"), [x])


def test_block_diag_stages_match_jax():
    """Folded streams: a grouped conv's group-major channel order is the
    block-diagonal kernel's m*C + c order, stride 2 included (the DRB)."""
    x = _rand(7, 1, 8, 8, 8, 4 * 3)
    _compare(jb.BlockDiagConv(4, 2, kernel_size=1), tb.block_diag_conv(4, 3, 2, 1), [x])
    _compare(jb.BlockDiagEncoderStage(4, 5, apply_pooling=True),
             tb.BlockDiagEncoderStage(4, 3, 5, apply_pooling=True), [x])
    _compare(jb.BlockDiagSingleConv(4, 4, 3, stride=2, order="ilc"),
             tb.BlockDiagSingleConv(4, 3, 4, stride=2, order="ilc"), [x])


def test_atten_module2_matches_jax():
    seg_x = _rand(8, 1, 8, 8, 8, 6)
    enc_x = _rand(9, 1, 8, 8, 8, 4)
    _compare(jb.AttenModule2(), tb.AttenModule2(), [seg_x, enc_x])


def test_decoder_stages_match_jax():
    skip = _rand(10, 1, 8, 8, 8, 4)
    x = _rand(11, 1, 4, 4, 4, 8)
    # seg decoder: x2 upsample, AttenModule2 join, DoubleConv
    _compare(jb.DecoderStage(4, order="ilc", rsm=True, mvae=True),
             tb.DecoderStage(8, 4, 4, rsm=True, order="ilc"), [skip, x])
    # recon decoder: x2 upsample, concat(skip, x), DoubleConv
    _compare(jb.DecoderStage(4, order="ilc"), tb.DecoderStage(8, 4, 4, order="ilc"),
             [skip, x])


def test_skr_gate_matches_jax():
    x = _rand(12, 1, 8, 8, 8, 8)
    _compare(JSkrGate(8), SkrGate(8), [x], jkw={"train": False})


@pytest.mark.parametrize("cin,features,stride,leaky,lkdw", [
    (8, 8, 1, True, False),    # ConvNorm + PReLU (alpha -> a 1-element weight)
    (4, 8, 2, False, False),   # strided ResBlock with the 1x1 identity branch
    (6, 6, 1, True, True),     # depthwise-separable with PReLU
])
def test_res_block_variants_match_jax(cin, features, stride, leaky, lkdw):
    from xlstm_hved_tpu.nn.skr import ResBlock as JResBlock
    from xlstm_hved_torch.nn.skr import ResBlock

    x = _rand(16, 1, 8, 8, 8, cin)
    _compare(JResBlock(features, stride, leaky, lkdw), ResBlock(cin, features, stride,
                                                              leaky, lkdw),
             [x], jkw={"train": False})


def test_duse_attention_matches_jax():
    x1 = _rand(13, 2, 8, 8, 8, 8)
    x2 = _rand(14, 2, 8, 8, 8, 8)
    _compare(JDuSE(8), DuSEAttention(8), [x1, x2], jkw={"train": False})


@pytest.mark.parametrize("spatial,chunk", [((4, 4, 4), 128), ((8, 6, 5), 128),
                                           ((8, 8, 8), 64)])
def test_vil_layer3d_matches_jax(spatial, chunk):
    """The bottleneck ViL at the flagship width (dim 32 -> NH 4, DH 16),
    one chunk and several, S not a multiple of L included."""
    x = _rand(15, 1, *spatial, 32)
    _compare(JViLLayer3D(32, chunk_size=chunk, use_pallas=False),
             ViLLayer3D(32, chunk_size=chunk), [x])


# The ViL at head width 8 normalises each head over 8 values, which amplifies
# fp32 rounding: both fp32 runs (JAX's and the port's) lie 1.8e-5 to 5.1e-5
# from an fp64 run of the port on these two cases (outputs up to 3.2 and 4.2)
VIL_DH8_ATOL = 1e-4


def test_double_conv_vil_matches_jax():
    """The ViL decoder block at U_HVEDConvXLSTMNet3D's stage-0 width: a
    decoder DoubleConv to 16 channels, LeakyReLU, a ViL of 4 heads of width
    8 over 4 * 6 * 5 tokens (S not a multiple of the chunk)."""
    x = _rand(17, 1, 4, 6, 5, 24)
    _compare(JDoubleConvViL(16, order="ilc"), DoubleConvViL(24, 16, "ilc"), [x],
             jkw={"train": False}, atol=VIL_DH8_ATOL)


def test_decoder_stage_with_the_vil_block_matches_jax():
    skip = _rand(18, 1, 8, 8, 8, 16)
    x = _rand(19, 1, 4, 4, 4, 32)
    _compare(jb.DecoderStage(16, basic_module="double_conv_vil", order="ilc", rsm=True,
                             mvae=True),
             tb.DecoderStage(32, 16, 16, rsm=True, order="ilc",
                             basic_module="double_conv_vil"), [skip, x], atol=VIL_DH8_ATOL)
    with pytest.raises(NotImplementedError, match="not ported"):
        tb.DecoderStage(32, 16, 16, basic_module="ext_resnet")


def test_drop_path_is_the_identity_residual_without_a_generator():
    x, res = torch.randn(6, 5, 3), torch.randn(6, 5, 3)
    torch.testing.assert_close(DropPath(0.5)(x, res), x + res, rtol=0, atol=0)
    torch.testing.assert_close(DropPath(0.0)(x, res, torch.Generator()), x + res,
                               rtol=0, atol=0)
    assert not list(DropPath(0.5).parameters())


def test_drop_path_drops_whole_samples_from_the_generator():
    """Per sample: x + residual / keep, or x alone; the same generator state
    draws the same mask; about `keep` of the samples survive."""
    x, res = torch.randn(4000, 3), torch.ones(4000, 3)
    got = DropPath(0.25)(x, res, torch.Generator().manual_seed(0))
    delta = got - x
    kept = delta[:, 0] > 0.5
    torch.testing.assert_close(delta[kept], torch.full_like(delta[kept], 1 / 0.75))
    torch.testing.assert_close(delta[~kept], torch.zeros_like(delta[~kept]))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    again = DropPath(0.25)(x, res, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    no_scale = DropPath(0.25, scale_by_keep=False)(x, res, torch.Generator().manual_seed(0))
    torch.testing.assert_close(no_scale - x, kept[:, None].float().expand(-1, 3))


def test_vil_block_drop_path_takes_the_generator():
    block = ViLBlock(8, drop_path=0.5).eval()
    x = torch.randn(3, 10, 8)
    with torch.no_grad():
        plain = x + block.layer(block.norm(x))
        torch.testing.assert_close(block(x), plain, rtol=0, atol=0)
        dropped = block(x, torch.Generator().manual_seed(1))
    for b in range(3):
        assert torch.allclose(dropped[b], x[b]) or torch.allclose(
            dropped[b], x[b] + 2.0 * (plain[b] - x[b]), atol=1e-6)
