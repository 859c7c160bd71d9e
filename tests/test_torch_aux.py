"""PyTorch port: the deformable conv (`xlstm_hved_torch/ops/deform.py`) and
the auxiliary blocks of `nn/skr.py` and `nn/dusfe.py` against the JAX
package's modules, on the same numpy-drawn weights (tests/_torch_port.py,
carried across by `params_from_jax`) and the same seeded input, in fp32 with
TF32 off, BatchNorm on its running statistics.

- Forward: max|d| <= 2e-5 * max|ref| + 1e-6 on every output.
- Gradients (the deformable blocks, ResFormerBlock(deform=True),
  DuRegisterDuSE and the bare gather): of a seeded weighted sum of the
  outputs with respect to the input and every parameter, per tensor
  ||d|| <= 1e-4 * ||ref|| (a tensor whose JAX gradient is 0 must be 0).
- The gather's offsets reach past every border (the offset conv's weights
  scaled up), and are zero (the offset conv's init): there every sample lies
  on the integer grid, the border taps on the clip's bound, where JAX's
  gradient is the forward difference and half the clip's. Stride 2 runs on
  an even and an odd size, where the offset conv's flax "SAME" padding is
  not symmetric.
- ConvNorm with norm "INSTANCE" and with a norm that is neither BATCH nor
  INSTANCE (no norm, as JAX reads it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from xlstm_hved_tpu.nn import dusfe as jd
from xlstm_hved_tpu.nn import skr as js
from xlstm_hved_tpu.ops import deform as jdef
from xlstm_hved_torch.nn import dusfe as td
from xlstm_hved_torch.nn import skr as ts
from xlstm_hved_torch.ops import deform as tdef
from xlstm_hved_torch.utils.convert import params_from_jax

FWD_SCALED, FWD_FLOOR = 2e-5, 1e-6
GRAD_REL = 1e-4
TRAIN = {"train": False}


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.rand(*s).astype(np.float32) for s in shapes]


def _offsets(variables, scale):
    """Scale every offset conv's weights (0: the zero init)."""
    def walk(tree):
        return {k: ({n: a * scale for n, a in v.items()} if k == "offset_conv"
                    else walk(v) if isinstance(v, dict) else v) for k, v in tree.items()}
    return dict(variables, params=walk(variables["params"]))


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _to_port(a):
    return tp.ncdhw(a) if a.ndim == 5 else torch.from_numpy(np.ascontiguousarray(a))


def _from_port(t):
    t = t.detach().numpy()
    return tp.ndhwc(t) if t.ndim == 5 else t


def check(jm, tm, xs, jax_kw=None, seed=0, offset_scale=None, grads=False):
    """Hold the port module `tm` to the JAX module `jm` on inputs `xs`
    (NDHWC numpy): forward, and with `grads` the gradients."""
    jax_kw = jax_kw or {}
    variables = {"params": {}, **tp.random_variables(jm, *map(jnp.asarray, xs), seed=seed,
                                                     **jax_kw)}
    if offset_scale is not None:
        variables = _offsets(variables, offset_scale)
    tp.load_port(tm, variables)
    jv = tp.to_jax(variables)
    want = _tuple(jax.jit(lambda v, *x: jm.apply(v, *x, **jax_kw))(jv, *map(jnp.asarray, xs)))
    txs = [_to_port(x).requires_grad_(grads) for x in xs]
    got = _tuple(tm(*txs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _from_port(g), np.asarray(w)
        assert g.shape == w.shape and np.all(np.isfinite(g))
        bound = FWD_SCALED * float(np.abs(w).max()) + FWD_FLOOR
        assert tp.max_abs(g, w) <= bound, (tp.max_abs(g, w), bound)
    if not grads:
        return
    weights = _inputs(seed + 100, *[np.asarray(w).shape for w in want])

    def loss(params, *x):
        out = _tuple(jm.apply(dict(jv, params=params), *x, **jax_kw))
        return sum(jnp.sum(o * w) for o, w in zip(out, weights))

    jg = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(xs)))))(
        jv["params"], *map(jnp.asarray, xs))
    want_params = params_from_jax(jax.tree.map(np.array, jg[0]))
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(want_params)
    total = sum((o * _to_port(w)).sum() for o, w in zip(got, weights))
    tg = torch.autograd.grad(total, txs + [p for _, p in tm.named_parameters()])
    pairs = [(f"input{i}", _from_port(g), np.asarray(w))
             for i, (g, w) in enumerate(zip(tg[:len(xs)], jg[1:]))]
    pairs += [(n, g.numpy(), want_params[n].numpy()) for n, g in zip(names, tg[len(xs):])]
    for name, g, w in pairs:
        d = np.linalg.norm((g.astype(np.float64) - w).ravel())
        ref = np.linalg.norm(w.astype(np.float64).ravel())
        assert d <= GRAD_REL * ref, (name, d, ref)


# ---- the gather

@pytest.mark.parametrize("coords", ["random", "integer"])
@pytest.mark.parametrize("batched", [False, True])
def test_trilinear_sample_matches_jax(coords, batched):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 5, 6, 7, 3).astype(np.float32) if batched else \
        rng.rand(5, 6, 7, 3).astype(np.float32)
    shape = x.shape[:-4] + (4, 9, 3) if batched else (4, 9, 3)
    if coords == "random":   # past every border
        c = (rng.rand(*shape) * 10 - 2.5).astype(np.float32)
    else:                    # on the grid, the bounds 0 and n - 1 included
        c = rng.randint(-1, 8, shape).astype(np.float32)
    fn = jax.vmap(jdef.trilinear_sample) if batched else jdef.trilinear_sample
    w = rng.randn(*(x.shape[:-4] + (4, 9, 3))).astype(np.float32)

    @jax.jit
    def forward_and_vjp(x, c, w):
        out, vjp = jax.vjp(fn, x, c)
        return (out,) + vjp(w)

    want, gx, gc = forward_and_vjp(jnp.asarray(x), jnp.asarray(c), jnp.asarray(w))
    tx = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -4))).requires_grad_()
    tc = torch.from_numpy(c).requires_grad_()
    got = tdef.trilinear_sample(tx, tc)                 # channels first
    got_cl = np.moveaxis(got.detach().numpy(), -3, -1)
    assert tp.max_abs(got_cl, want) <= FWD_SCALED * float(np.abs(want).max()) + FWD_FLOOR
    tw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(w, -1, -3)))
    dx, dc = torch.autograd.grad((got * tw).sum(), (tx, tc))
    for g, r in ((np.moveaxis(dx.numpy(), -4, -1), gx), (dc.numpy(), gc)):
        r = np.asarray(r)
        assert np.linalg.norm(g - r) <= GRAD_REL * np.linalg.norm(r)


# ---- the deformable convs

DEFORM = {  # offsets scale, size, stride
    "offsets-past-the-borders": (30.0, 8, 1),
    "zero-offsets": (0.0, 8, 1),
    "stride2-even": (30.0, 8, 2),
    "stride2-odd": (30.0, 7, 2),
    "zero-offsets-stride2-odd": (0.0, 7, 2),
}


@pytest.mark.parametrize("case", sorted(DEFORM))
def test_deform_conv3d_matches_jax(case):
    scale, n, stride = DEFORM[case]
    x, = _inputs(1, (1, n, n, n, 4))
    check(jdef.DeformConv3d(6, 3, stride), tdef.DeformConv3d(4, 6, 3, stride), [x],
          seed=2, offset_scale=scale, grads=True)


@pytest.mark.parametrize("case", ["offsets-past-the-borders", "zero-offsets", "stride2-odd"])
def test_att_deform_conv3d_matches_jax(case):
    scale, n, stride = DEFORM[case]
    x, = _inputs(4, (2, n, n, n, 8))
    check(jdef.AttDeformConv3d(5, 3, stride), tdef.AttDeformConv3d(8, 5, 3, stride), [x],
          seed=5, offset_scale=scale, grads=True)


def test_deform_conv3d_is_zero_initialised_and_samples_the_grid():
    """At init (zero offsets) the deformable conv is a dense k^3 conv whose
    taps are the proj kernel's tap-major blocks."""
    torch.manual_seed(0)
    m = tdef.DeformConv3d(3, 5, 3)
    assert not m.offset_conv.weight.any() and not m.offset_conv.bias.any()
    x = torch.rand(1, 3, 6, 6, 6)
    with torch.no_grad():
        w = m.proj.weight.reshape(5, 27, 3).transpose(1, 2).reshape(5, 3, 3, 3, 3)
        dense = torch.nn.functional.conv3d(torch.nn.functional.pad(x, (1,) * 6, "replicate"), w)
        assert tp.max_abs(m(x), dense) < 1e-5


@pytest.mark.parametrize("case", ["offsets-past-the-borders", "zero-offsets", "stride2-even",
                                  "stride2-odd"])
def test_resformer_block_deform_matches_jax(case):
    scale, n, stride = DEFORM[case]
    x, = _inputs(6, (1, n, n, n, 4))
    check(js.ResFormerBlock(6, stride=stride, leaky=True, deform=True),
          ts.ResFormerBlock(4, 6, stride=stride, leaky=True, deform=True), [x],
          TRAIN, seed=7, offset_scale=scale, grads=True)


# ---- the skr auxiliary blocks

@pytest.mark.parametrize("norm", ["BATCH", "INSTANCE", "NONE"])
@pytest.mark.parametrize("leaky", [True, False])
def test_conv_norm_matches_jax(norm, leaky):
    x, = _inputs(8, (2, 6, 6, 6, 3))
    check(js.ConvNorm(5, 3, 2, leaky=leaky, norm=norm),
          ts.ConvNorm(3, 5, 3, 2, leaky=leaky, norm=norm), [x], TRAIN, seed=9)


def test_conv_norm_deform_matches_jax():
    x, = _inputs(31, (1, 7, 7, 7, 4))
    check(js.ConvNorm(5, 3, 2, deform=True), ts.ConvNorm(4, 5, 3, 2, deform=True), [x],
          TRAIN, seed=32, offset_scale=30.0)


@pytest.mark.parametrize("norm", ["INSTANCE", "GROUP"])
def test_dw_conv_norm_takes_jax_norms(norm):
    x, = _inputs(10, (1, 6, 6, 6, 4))
    check(js.DWConvNorm(6, norm=norm), ts.DWConvNorm(4, 6, norm=norm), [x], TRAIN, seed=11)


@pytest.mark.parametrize("kw", [dict(stride=1), dict(stride=2, leaky=True),
                                dict(lkdw=True), dict(norm="INSTANCE")],
                         ids=["plain", "stride2-leaky", "lkdw", "instance"])
def test_resformer_block_matches_jax(kw):
    x, = _inputs(12, (1, 8, 8, 8, 4))
    check(js.ResFormerBlock(6, **kw), ts.ResFormerBlock(4, 6, **kw), [x], TRAIN, seed=13)


@pytest.mark.parametrize("kw,cout", [(dict(), 8), (dict(stride=2, leaky=True), 12)],
                         ids=["identity", "stride2-leaky"])
def test_res_bottleneck_matches_jax(kw, cout):
    x, = _inputs(14, (1, 8, 8, 8, 8))
    jm, tm = js.ResBottleneck(cout, **kw), ts.ResBottleneck(8, cout, **kw)
    assert tm.conv1.conv.out_channels == 2   # max(cin // 4, 1)
    check(jm, tm, [x], TRAIN, seed=15)


@pytest.mark.parametrize("use_deconv", [False, True])
def test_scale_upsample_matches_jax(use_deconv):
    x, = _inputs(16, (1, 4, 5, 3, 3))
    check(js.ScaleUpsample(2, use_deconv, features=5 if use_deconv else None),
          ts.ScaleUpsample(3, 2, use_deconv, 5 if use_deconv else None), [x], seed=17)


def test_attention_connection_matches_jax():
    f, a = _inputs(18, (1, 4, 4, 4, 3), (1, 4, 4, 4, 1))
    check(js.AttentionConnection(0.7), ts.AttentionConnection(0.7), [f, a], seed=19)


@pytest.mark.parametrize("n", [8, 7])
def test_attention_gate_matches_jax(n):
    half = (n + 1) // 2
    g, x = _inputs(20, (1, half, half, half, 6), (1, n, n, n, 4))
    check(js.AttentionGate(5), ts.AttentionGate(6, 4, 5), [g, x], TRAIN, seed=21)


@pytest.mark.parametrize("head", ["ParallelDecoder", "FCNHead"])
def test_three_scale_heads_match_jax(head):
    x3, x4, x5 = _inputs(22, (1, 12, 12, 12, 4), (1, 6, 6, 6, 8), (1, 3, 3, 3, 16))
    check(getattr(js, head)(3), getattr(ts, head)(4, 8, 16, 3), [x3, x4, x5], TRAIN,
          seed=23)


def test_senet3d_matches_jax():
    x, = _inputs(24, (2, 4, 4, 4, 32))
    check(js.SENet3D(8), ts.SENet3D(32, 8), [x], seed=25)


# ---- the dusfe auxiliary blocks

def test_make_dense_and_rdb_match_jax():
    x, = _inputs(26, (1, 6, 6, 6, 4))
    check(jd.MakeDense(3), td.MakeDense(4, 3), [x], TRAIN, seed=27)
    check(jd.RDB(4, num_dense=3, growth=5), td.RDB(4, num_dense=3, growth=5), [x], TRAIN,
          seed=28)


def test_du_register_duse_matches_jax():
    x1, x2 = _inputs(29, (2, 16, 16, 8, 1), (2, 16, 16, 8, 1))
    tm = td.DuRegisterDuSE(4, img_size=(16, 16, 8))
    assert tm.fc1.in_features == 16 * 2 * 2 * 1
    check(jd.DuRegisterDuSE(4), tm, [x1, x2], TRAIN, seed=30, grads=True)
    with pytest.raises(ValueError, match="built for inputs"):
        tm(torch.rand(1, 1, 16, 16, 16), torch.rand(1, 1, 16, 16, 16))


def test_du_register_duse_upstream_width():
    assert td.DuRegisterDuSE().fc1.in_features == 16 * 10 * 10 * 5
