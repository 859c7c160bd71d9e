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
from xlstm_hved_tpu.nn import gates as jg
from xlstm_hved_tpu.nn.dusfe import DuSEAttention as JDuSE
from xlstm_hved_tpu.nn.skr import SkrGate as JSkrGate
from xlstm_hved_tpu.nn.vil import DoubleConvViL as JDoubleConvViL
from xlstm_hved_tpu.nn.vil import ViLLayer3D as JViLLayer3D
from xlstm_hved_torch.nn import blocks as tb
from xlstm_hved_torch.nn import gates as tg
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
    j_out = j_out if isinstance(j_out, (tuple, list)) else (j_out,)
    t_out = t_out if isinstance(t_out, (tuple, list)) else (t_out,)
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


@pytest.mark.parametrize("order", ["cr", "ce", "gcr", "cge", "bcl", "clb", "icg"])
def test_single_conv_orders_match_jax(order):
    """The r / e / g / b chars: ReLU, ELU, GroupNorm (flax's eps 1e-6 and
    fast variance; 8 groups at 16 channels, 1 group at 6) and BatchNorm on
    its running statistics; no conv bias with g or b."""
    x = _rand(20, 1, 6, 6, 6, 6, scale=2.0) + 1.0
    _compare(jb.SingleConv(16, 3, 1, order), tb.SingleConv(6, 16, order), [x])
    _compare(jb.SingleConv(4, 3, 1, order, num_groups=2),
             tb.SingleConv(6, 4, order, num_groups=2), [x])
    conv = tb.SingleConv(6, 16, order).Conv3DFast_0
    assert (conv.bias is None) == ("g" in order or "b" in order)


def test_double_conv_pool_stride_and_avg_pool_match_jax():
    x = _rand(21, 1, 8, 6, 4, 8)
    # the mean of 8 values, summed in another order
    np.testing.assert_allclose(ndhwc(tb.avg_pool3d(ncdhw(x))),
                               np.asarray(jb.avg_pool3d(jnp.asarray(x))), rtol=0, atol=1e-6)
    _compare(jb.DoubleConv(8, encoder=True, pool_stride=2, order="gce", num_groups=4),
             tb.DoubleConv(8, 8, encoder=True, order="gce", pool_stride=2, num_groups=4), [x])


def test_block_diag_orders():
    """The folded-stream conv takes r and e; GroupNorm and BatchNorm would
    mix the streams' channels and are refused, as in the JAX package."""
    x = _rand(22, 1, 6, 6, 6, 8)
    _compare(jb.BlockDiagSingleConv(4, 3, order="cre"),
             tb.BlockDiagSingleConv(4, 2, 3, order="cre"), [x])
    for order in ("gcr", "cb"):
        with pytest.raises(NotImplementedError, match="supported"):
            tb.BlockDiagSingleConv(4, 2, 3, order=order)


@pytest.mark.parametrize("order", ["ilc", "cge"])
def test_ext_resnet_blocks_match_jax(order):
    """The residual is conv1's output after its whole order string; no
    nonlinearity after the sum."""
    x = _rand(23, 1, 8, 8, 8, 8)
    _compare(jb.ExtResNetBlock(8, order=order, num_groups=4),
             tb.ExtResNetBlock(8, 8, order, num_groups=4), [x])
    xs = _rand(25, 1, 8, 8, 8, 4 * 3)
    _compare(jb.BlockDiagExtResNetBlock(4, 5, order="ilc"),
             tb.BlockDiagExtResNetBlock(4, 3, 5, "ilc"), [xs])


@pytest.mark.parametrize("pool_type", ["max", "avg", "conv"])
def test_encoder_stages_with_ext_resnet_and_pool_types_match_jax(pool_type):
    """EncoderStage: max or average pooling, or the strided conv with flax's
    "SAME" padding (an odd size included), then ext-resnet blocks; the
    folded-stream stage with ext-resnet blocks."""
    x = _rand(26, 1, 8, 7, 6, 4)
    _compare(jb.EncoderStage(8, num_block=2, pool_type=pool_type, basic_module="ext_resnet",
                             order="ilc"),
             tb.EncoderStage(4, 8, 2, "ilc", "ext_resnet", pool_type), [x])
    xs = _rand(27, 1, 8, 8, 8, 4 * 3)
    _compare(jb.BlockDiagEncoderStage(4, 5, basic_module="ext_resnet", order="ilc"),
             tb.BlockDiagEncoderStage(4, 3, 5, order="ilc", basic_module="ext_resnet"), [xs])


def test_ext_resnet_decoder_stages_match_jax():
    """pre_conv (1x1 with a bias) before the upsampling; then the sum join
    (recon ladder), AttenModule2 (the MVAE seg decoder: 2 x features into
    the block) or no skip at all, upsampling to `up_size`."""
    skip = _rand(28, 1, 8, 8, 8, 4)
    x = _rand(29, 1, 4, 4, 4, 8)
    _compare(jb.DecoderStage(4, basic_module="ext_resnet", order="ilc"),
             tb.DecoderStage(8, 4, 4, order="ilc", basic_module="ext_resnet"), [skip, x])
    _compare(jb.DecoderStage(4, basic_module="ext_resnet", order="ilc", rsm=True, mvae=True),
             tb.DecoderStage(8, 4, 4, rsm=True, order="ilc", basic_module="ext_resnet"),
             [skip, x])
    jstage = jb.DecoderStage(4, basic_module="ext_resnet", order="ilc")
    variables = random_variables(jstage, None, jnp.asarray(x), (8, 8, 8))
    tstage = load_port(tb.DecoderStage(8, 0, 4, order="ilc", basic_module="ext_resnet"),
                       variables)
    want = jax.jit(lambda v, x: jstage.apply(v, None, x, (8, 8, 8)))(to_jax(variables),
                                                                      jnp.asarray(x))
    with torch.no_grad():
        got = tstage(None, ncdhw(x), [8, 8, 8])
    assert max_abs(ndhwc(got), want) <= ATOL
    with pytest.raises(ValueError, match="sum join"):
        tb.DecoderStage(8, 6, 4, basic_module="ext_resnet")


def test_decoder_stage_with_modality_skip_lists_matches_jax():
    """The fusion seg decoder: a list of per-modality skips concatenated in
    order before x."""
    skips = [_rand(30 + m, 1, 8, 8, 8, 3) for m in range(4)]
    x = _rand(34, 1, 4, 4, 4, 16)
    jstage = jb.DecoderStage(8, order="ilc")
    jin = [[jnp.asarray(a) for a in skips], jnp.asarray(x)]
    variables = random_variables(jstage, *jin)
    tstage = load_port(tb.DecoderStage(16, 12, 8, order="ilc"), variables)
    want = jax.jit(jstage.apply)(to_jax(variables), *jin)
    with torch.no_grad():
        got = tstage([ncdhw(a) for a in skips], ncdhw(x))
    assert max_abs(ndhwc(got), want) <= ATOL


def test_atten_module_and_its_decoder_stage_match_jax():
    """The non-MVAE RSM join (no preset reaches it): AttenModule on its own
    and inside a DecoderStage, as the JAX aux-block test sets it up."""
    rng = np.random.RandomState(0)
    x = rng.rand(1, 4, 4, 4, 64).astype(np.float32)
    encs = [rng.rand(1, 8, 8, 8, 8).astype(np.float32) for _ in range(4)]
    recons = [rng.rand(1, 8, 8, 8, 8).astype(np.float32) for _ in range(4)]
    jx, jencs, jrecons = jnp.asarray(x), [jnp.asarray(a) for a in encs], \
        [jnp.asarray(a) for a in recons]
    seg = rng.rand(1, 8, 8, 8, 6).astype(np.float32)
    jatt = jb.AttenModule(32)
    variables = random_variables(jatt, jnp.asarray(seg), jencs, jrecons)
    tatt = load_port(tb.AttenModule(32, 32), variables)
    want = jax.jit(jatt.apply)(to_jax(variables), jnp.asarray(seg), jencs, jrecons)
    with torch.no_grad():
        got = tatt(ncdhw(seg), [ncdhw(a) for a in encs], [ncdhw(a) for a in recons])
    assert got.shape == (1, 6 + 32, 8, 8, 8)
    assert max_abs(ndhwc(got), want) <= ATOL

    jstage = jb.DecoderStage(features=32, rsm=True, mvae=False, order="ilc")
    variables = random_variables(jstage, jencs, jx, None, False, jrecons)
    tstage = load_port(tb.DecoderStage(64, 32, 32, rsm=True, mvae=False, order="ilc",
                                       recon_ch=32), variables)
    want = jax.jit(lambda v, e, x, r: jstage.apply(v, e, x, None, False, r))(
        to_jax(variables), jencs, jx, jrecons)
    with torch.no_grad():
        got = tstage([ncdhw(a) for a in encs], ncdhw(x),
                     recon_features=[ncdhw(a) for a in recons])
    assert got.shape == (1, 32, 8, 8, 8)
    assert max_abs(ndhwc(got), want) <= ATOL
    with pytest.raises(ValueError, match="lists"):
        tstage(ncdhw(encs[0]), ncdhw(x))


def test_gates_match_jax():
    """ChannelGate, ModalityGate (one scale per modality chunk), SpatialGate
    (with and without the extra prob maps) and FusionModule in both modes,
    with the Dense_0 / Dense_1 names of the flax tree."""
    x = _rand(40, 2, 6, 6, 6, 16)
    _compare(jg.ChannelGate(16), tg.ChannelGate(16), [x])
    _compare(jg.ModalityGate(16, 4), tg.ModalityGate(16, 4), [x])
    _compare(jg.SpatialGate(), tg.SpatialGate(), [x])
    prob = _rand(41, 2, 6, 6, 6, 3)
    _compare(jg.SpatialGate(), tg.SpatialGate(3), [x, prob])
    feats = [_rand(42 + m, 1, 6, 6, 6, 4) for m in range(4)]
    for mode in ("modal", "ch"):
        jmod = jg.FusionModule(8, mode=mode)
        jin = [jnp.asarray(a) for a in feats]
        variables = random_variables(jmod, jin)
        tmod = load_port(tg.FusionModule(16, 8, mode), variables)
        want_out, want_gated = jax.jit(jmod.apply)(to_jax(variables), jin)
        with torch.no_grad():
            got_out, got_gated = tmod([ncdhw(a) for a in feats])
        assert max_abs(ndhwc(got_out), want_out) <= ATOL
        assert len(got_gated) == len(want_gated) == (4 if mode == "modal" else 1)
        for g, w in zip(got_gated, want_gated):
            assert max_abs(ndhwc(g), w) <= ATOL


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
    with pytest.raises(ValueError, match="unknown basic_module"):
        tb.DecoderStage(32, 16, 16, basic_module="resnet")


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
