"""PyTorch port: the JAX precision policy on the CPU (bf16 compute for G,
D in its own dtype, norm statistics and the ViL in fp32, fp32 outputs,
parameters and optimizer state).

The JAX side comes from tests/make_torch_precision_ref.py (no JAX compile
here): the weights of the stored forward goldens, JAX's bf16-vs-fp32
forward distances on them at 32^3, and JAX's bf16-vs-fp32 G-gradient
distances on the numpy-drawn weights of tests/_torch_port.py. chip_smoke.py
phase 9 bounds the card's bf16 runs at full size with the same numbers
(`chip_smoke.precision_ref`).

- Forward: XLSTM_HVED at 16^3 on the goldens' weights, input and subset.
  The port's bf16-vs-fp32 distance (seg and recon, max and mean |d|) is at
  most FACTOR times JAX's (tests/goldens/XLSTM_HVED_bf16.npz against
  XLSTM_HVED.npz); measured 0.83-0.96 of it. The port's bf16 output lies
  within GOLDEN_SHARE of JAX's own bf16-vs-fp32 distance from JAX's bf16
  golden (measured 0.33-0.47): the two bf16 runs round in different places
  (a fused conv bias, another summation order), but they are nearer each
  other than either is to fp32. At 32^3 (all modalities) the same holds
  for the max, the mean and the 99.9th percentile of |d|.
- G gradient: the generator objective at 16^3 with the latent noise off.
  The port's bf16 G gradient (G and D bf16) against JAX's bf16 G gradient
  itself, over all parameters at once: their distance at most GRAD_SHARE
  of JAX's own bf16-vs-fp32 distance (measured 0.700; the check's planted
  faults read 1.000 for an fp32 gradient, 1.075 for a zero one, 1.45 for a
  random one of the same norm, and the tests show that each fails it).
  Beside it, the per-tensor relative L2 of bf16 against fp32, the port's
  against JAX's: median, 90th percentile and the value over all tensors,
  each at most FACTOR times JAX's. Single tensors are not compared: at 16^3
  the stacked InstanceNorms (down to 2^3 voxels) make the bf16 gradient of
  most tensors rounding noise (median distance 0.85 in both packages), so
  the two packages' bf16 gradients agree tensor by tensor no better than
  either agrees with fp32.
- One block's bf16 backward (an encoder stage, a block-diagonal encoder
  stage, a seg decoder stage) against JAX's on the same weights, inputs
  and cotangents: the distance of all its gradients (weights and inputs) at
  most BLOCK_SHARE of JAX's bf16-vs-fp32 distance (measured 0.26, 0.57,
  0.10): the two packages round in the same places, so the port lies much
  nearer JAX's bf16 backward than JAX's lies to fp32. Norm statistics
  taken in bf16 (a planted fault) read 2.18 and 2.93 on the encoder
  stages, an fp32 block 1.000. The gate blocks (SkrGate, DuSE) are not
  compared so: their broadcast products' gradients are sums over the
  volume, which the port adds in fp32 and JAX's CPU backend adds in bf16
  (a 1024-term sum: 2.9e-2 relative error against 1.8e-3 for one rounding).
- The dtype map of a bf16 step, and the one-pass InstanceNorm moments and
  the half-precision BatchNorm against JAX's and flax's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import _torch_port as tp
import xlstm_hved_torch.nn.blocks as tb
import xlstm_hved_torch.nn.vil as tvil
from chip_smoke import GRAD_SHARE, bf16_gradient_share, npz_tree, precision_ref
from make_torch_precision_ref import (BLOCK_CASES, KEEP, OUT, S, block_cotangent, block_inputs,
                                      distances, flat, forward_input, g_inputs)
from xlstm_hved_tpu.nn.blocks import instance_norm as jax_instance_norm
from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.engine import train as ttrain
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.nn.blocks import BatchNorm3d, Conv3d, Linear, instance_norm
from xlstm_hved_torch.nn.vil import ViLBlock, ViLLayer3D
from xlstm_hved_torch.utils.convert import params_from_jax
from xlstm_hved_torch.utils.subsets import SUBSET_MASKS

FACTOR = 2.0
GOLDEN_SHARE = 0.75
BLOCK_SHARE = 0.75
BF16 = torch.bfloat16
GOLDENS = "tests/goldens/XLSTM_HVED{}.npz"


@pytest.fixture(scope="module")
def ref():
    return np.load(OUT)


def _port_forwards(weights, x, keep=None):
    """{dtype: {"seg", "recon"}} of the port's fp32 and bf16 forwards, NDHWC."""
    port = {}
    for dtype in ("float32", "bfloat16"):
        model = find_model_using_name("XLSTM_HVED", device="cpu", compute_dtype=dtype)
        model.load_state_dict(weights, strict=True)
        with torch.no_grad():
            out = model(tp.ncdhw(x), keep=keep, recon=True, deterministic=True)
        port[dtype] = {"seg": tp.ndhwc(out.seg), "recon": tp.ndhwc(out.recon)}
    return port


@pytest.fixture(scope="module")
def pref():
    return precision_ref()


@pytest.fixture(scope="module")
def weights(pref):
    """The goldens' JAX-initialised weights, through params_from_jax."""
    return pref["weights"]


@pytest.fixture(scope="module")
def forwards(weights):
    """The port's fp32 and bf16 forwards on the goldens' weights and input,
    and the JAX goldens, NDHWC."""
    x = np.random.RandomState(7).rand(1, S, S, S, 4).astype(np.float32)
    port = _port_forwards(weights, x, torch.from_numpy(SUBSET_MASKS[10]))
    jax = {dtype: np.load(GOLDENS.format(suffix))
           for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16"))}
    return port, jax


@pytest.mark.parametrize("head", ["seg", "recon"])
def test_bf16_forward_distance_within_jax(forwards, head):
    port, jax = forwards
    got = distances(port["bfloat16"][head], port["float32"][head])
    want = distances(jax["bfloat16"][head], jax["float32"][head])
    for stat in ("max", "mean"):
        assert got[stat] <= FACTOR * want[stat], (head, stat, got, want)
    # the fp32 forwards agree to the port's fp32 budget (tests/test_torch_hved.py)
    assert distances(port["float32"][head], jax["float32"][head])["max"] <= \
        {"seg": 1e-3, "recon": 3.5e-3}[head]


@pytest.mark.parametrize("head", ["seg", "recon"])
def test_bf16_forward_near_the_jax_bf16_golden(forwards, head):
    port, jax = forwards
    got = distances(port["bfloat16"][head], jax["bfloat16"][head])
    jax_own = distances(jax["bfloat16"][head], jax["float32"][head])
    for stat in ("max", "mean"):
        assert got[stat] <= GOLDEN_SHARE * jax_own[stat], (head, stat, got, jax_own)


@pytest.mark.parametrize("head", ["seg", "recon"])
def test_bf16_forward_distance_within_jax_at_32(weights, ref, head):
    """The numbers chip_smoke.py phase 9 bounds the card's forward with."""
    port = _port_forwards(weights, forward_input())
    got = distances(port["bfloat16"][head], port["float32"][head])
    for stat in ("max", "mean", "p999"):
        want = float(ref[f"forward32.{head}.{stat}"])
        assert got[stat] <= FACTOR * want, (head, stat, got[stat], want)


@pytest.fixture(scope="module")
def g_grads(pref):
    """The port's G gradients in fp32 and in bf16 (G and D bf16) on the
    generator's weights and inputs."""
    x, mask = g_inputs()
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = find_model_using_name("XLSTM_HVED", device="cpu", compute_dtype=dtype)
        model.load_state_dict(pref["g_weights"], strict=True)
        disc = Discriminator(f_maps=8, kernel=3, dtype=BF16 if dtype == "bfloat16" else None)
        disc.load_state_dict(pref["d_weights"], strict=True)
        loss, grads = ttrain.make_grad_fn(model, disc, TrainConfig(crop_size=(S,) * 3))(
            tp.ncdhw(x), tp.ncdhw(mask), torch.from_numpy(KEEP), deterministic=True)
        assert all(g.dtype == torch.float32 for g in grads.values())
        out[dtype] = (float(loss), {k: v.double().numpy() for k, v in grads.items()})
    return out


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


def test_bf16_g_gradient_distance_within_jax(g_grads, ref, pref):
    (loss32, g32), (loss16, g16) = g_grads["float32"], g_grads["bfloat16"]
    # the bf16 gradient against JAX's bf16 gradient itself
    share = bf16_gradient_share(g16, pref)
    assert share <= GRAD_SHARE, share
    names = sorted(g32)
    assert {f"grad.rel_l2.{n}" for n in names} <= set(ref.files)
    port = np.array([_rel_l2(g16[n], g32[n]) for n in names])
    jax = np.array([float(ref[f"grad.rel_l2.{n}"]) for n in names])
    for q in (0.5, 0.9):
        assert np.quantile(port, q) <= FACTOR * np.quantile(jax, q), (q, port, jax)
    assert _rel_l2(flat(g16), flat(g32)) <= FACTOR * float(ref["grad.rel_l2_all"])
    # the losses: fp32 with JAX's, bf16 nearer JAX's bf16 than JAX's is to fp32
    jax32, jax16 = float(ref["grad.loss.float32"]), float(ref["grad.loss.bfloat16"])
    np.testing.assert_allclose(loss32, jax32, rtol=1e-4)
    assert abs(loss16 - jax16) <= abs(jax16 - jax32)


@pytest.mark.parametrize("fault", ["fp32", "zero", "random"])
def test_bf16_g_gradient_check_rejects_planted_faults(g_grads, pref, fault):
    """The direct check above fails for an fp32 gradient passed off as the
    bf16 one, for an all-zero gradient and for a random one of the bf16
    gradient's norm."""
    g32, g16 = g_grads["float32"][1], g_grads["bfloat16"][1]
    rng = np.random.RandomState(0)
    scale = np.linalg.norm(flat(g16)) / np.sqrt(flat(g16).size)
    bad = {"fp32": g32, "zero": {n: np.zeros_like(g) for n, g in g16.items()},
           "random": {n: scale * rng.randn(*g.shape) for n, g in g16.items()}}[fault]
    assert bf16_gradient_share(bad, pref) > GRAD_SHARE


def _port_block(case, dtype):
    block = {"encoder": lambda: tb.EncoderStage(4, 8, order="ilc"),
             "block_diag": lambda: tb.BlockDiagEncoderStage(4, 3, 5, apply_pooling=True),
             "decoder": lambda: tb.DecoderStage(8, 4, 4, rsm=True, order="ilc")}[case]()
    return tb.set_compute_dtype(block, dtype)


def _block_share(ref, case, dtype=BF16):
    """The port block's gradients (weights and inputs) in `dtype` against
    JAX's bf16 ones: their distance over JAX's bf16-vs-fp32 distance."""
    module = _port_block(case, dtype)
    module.load_state_dict(params_from_jax(npz_tree(ref, f"block.{case}.params")), strict=True)
    xs = [tp.ncdhw(a).to(dtype or torch.float32).requires_grad_() for a in block_inputs(case)]
    outs = module(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = [tp.ncdhw(block_cotangent(i, (o.shape[0], *o.shape[2:], o.shape[1]))).to(o.dtype)
           for i, o in enumerate(outs)]
    torch.autograd.backward(outs, cts)
    got = {n: p.grad.double().numpy() for n, p in module.named_parameters()}
    got.update({f"input{i}": x.grad.double().numpy() for i, x in enumerate(xs)})
    prefix = f"block.{case}.bf16."
    want = {k[len(prefix):]: ref[k].astype(np.float64) for k in ref.files if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    return float(np.linalg.norm(flat(got) - flat(want)) / ref[f"block.{case}.dist"])


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_bf16_block_gradients_match_jax(ref, case):
    assert _block_share(ref, case) <= BLOCK_SHARE


def _instance_norm_bf16_statistics(x, eps=1e-5):
    """A planted fault: InstanceNorm with its statistics taken in bf16."""
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return ((x - mean) * torch.rsqrt(var + eps)).to(x.dtype)


@pytest.mark.parametrize("fault,case", [("bf16-norm-statistics", "encoder"),
                                        ("bf16-norm-statistics", "block_diag"),
                                        ("fp32-block", "encoder")])
def test_bf16_block_check_rejects_planted_faults(ref, monkeypatch, fault, case):
    if fault == "bf16-norm-statistics":
        monkeypatch.setattr(tb, "instance_norm", _instance_norm_bf16_statistics)
        share = _block_share(ref, case)
    else:
        share = _block_share(ref, case, dtype=None)
    assert share > BLOCK_SHARE


class _DtypeLog(torch.overrides.TorchFunctionMode):
    """Records the dtype of every rsqrt's input: the norms' 1 / sqrt(var + eps)."""

    def __init__(self):
        super().__init__()
        self.rsqrt = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.rsqrt, torch.Tensor.rsqrt):
            self.rsqrt.add(args[0].dtype)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("disc_dtype", ["float32", "bfloat16"])
def test_dtype_map_of_a_bf16_step(disc_dtype, monkeypatch):
    """One bf16 train step (G bf16, D at disc_dtype): the convs and dense
    layers of G run bf16, D's at disc_dtype; BatchNorm takes bf16 in and out
    with fp32 running statistics; every norm's statistics are fp32; the ViL
    takes bf16, runs fp32 inside and hands back bf16; the mLSTM receives
    fp32; the outputs are fp32; parameters, gradients and the Adam state
    stay fp32."""
    seen = {}

    def record(kind):
        def hook(module, args, out):
            ins = {a.dtype for a in args if torch.is_tensor(a) and a.is_floating_point()}
            outs = out if isinstance(out, tuple) else (out,)
            seen.setdefault(kind, set()).update(
                (str(i), str(o.dtype)) for i in ins for o in outs if torch.is_tensor(o))
        return hook

    cfg = TrainConfig(crop_size=(S,) * 3)
    model = find_model_using_name("XLSTM_HVED", device="cpu", compute_dtype="bfloat16")
    disc = Discriminator(f_maps=8, kernel=3, dtype=BF16 if disc_dtype == "bfloat16" else None)
    vil = {id(m) for v in model.modules() if isinstance(v, ViLLayer3D) for m in v.modules()}
    for name, m in model.named_modules():
        if id(m) in vil:
            if isinstance(m, (ViLLayer3D, ViLBlock)):
                m.register_forward_hook(record(type(m).__name__))
        elif isinstance(m, (Conv3d, Linear, BatchNorm3d)):
            m.register_forward_hook(record(f"G {type(m).__name__}"))
    for m in disc.modules():
        if isinstance(m, Conv3d):
            m.register_forward_hook(record("D Conv3d"))
    mlstm_in = set()

    def mlstm(*args, **kwargs):
        mlstm_in.update(t.dtype for t in args)
        return plain_mlstm(*args, **kwargs)

    plain_mlstm = tvil.mlstm_chunkwise
    monkeypatch.setattr(tvil, "mlstm_chunkwise", mlstm)
    x, mask = (tp.ncdhw(a) for a in g_inputs())
    state = ttrain.create_train_state(model, disc, cfg, 0, x)
    step = ttrain.make_train_step(model, disc, cfg)
    log = _DtypeLog()
    with log:
        state, metrics = step(state, x, mask)
    assert all(np.isfinite(float(v)) for v in metrics.values())

    bf, f32 = str(BF16), str(torch.float32)
    d = bf if disc_dtype == "bfloat16" else f32
    assert seen["G Conv3d"] == {(bf, bf)}
    assert seen["G Linear"] == {(bf, bf)}
    assert seen["G BatchNorm3d"] == {(bf, bf)}
    assert seen["D Conv3d"] == {(f32, d)} | ({(d, d)} if d != f32 else set())
    assert seen["ViLLayer3D"] == {(bf, bf)} and seen["ViLBlock"] == {(f32, f32)}
    assert mlstm_in == {torch.float32}
    assert log.rsqrt == {torch.float32}
    for name, b in model.named_buffers():
        assert b.dtype in (torch.float32, torch.int64), name
    for p in list(model.parameters()) + list(disc.parameters()):
        assert p.dtype == torch.float32
    for opt in (state.opt_g, state.opt_d):
        moments = [t for s in opt.state.values() for t in s.values() if t.ndim > 0]
        assert moments and all(t.dtype == torch.float32 for t in moments)

    model.eval()
    with torch.no_grad():
        out = model(x, keep=torch.from_numpy(KEEP), recon=True, deterministic=True)
    assert {out.seg.dtype, out.recon.dtype} == {torch.float32}
    assert {t.dtype for t in out.mu + out.logvar} == {torch.float32}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_instance_norm_matches_jax(dtype):
    """bf16 input: JAX's one-pass moments (fp32 statistics, the output
    rounded to bf16: equal up to one bf16 rounding step, where the fp32
    statistics summed in another order tip a value over a rounding
    boundary); fp32 input: the two-pass centred variance."""
    a = (3.0 + 2.0 * np.random.RandomState(0).randn(2, 6, 6, 6, 5)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_instance_norm(jnp.asarray(a).astype(jd)).astype(jnp.float32))
    x = tp.ncdhw(a).to(getattr(torch, dtype))
    got = instance_norm(x)
    assert got.dtype == x.dtype
    got = tp.ndhwc(got.float())
    if dtype == "bfloat16":
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= step)
        assert np.mean(got == want) > 0.99
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batchnorm_in_half_precision_matches_flax():
    """flax BatchNorm(dtype=bf16) on a bf16 input, train and eval mode:
    fp32 statistics, the output in bf16, the running statistics fp32."""
    rng = np.random.RandomState(1)
    a = (2.0 + 3.0 * rng.randn(2, 4, 4, 4, 5)).astype(np.float32)
    xj = jnp.asarray(a).astype(jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.bfloat16)
    variables = tp.to_jax(tp.random_variables(bn, xj))
    tbn = BatchNorm3d(5)
    tbn.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"]))
    want, new = bn.apply(variables, xj, mutable=["batch_stats"])
    got = tbn.train()(tp.ncdhw(a).to(BF16))
    assert got.dtype == BF16 and tbn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(tp.ndhwc(got.detach().float()), np.asarray(want, np.float32),
                               atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(tbn.running_mean, new["batch_stats"]["mean"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tbn.running_var, new["batch_stats"]["var"], rtol=1e-5)
    variables = {"params": variables["params"], "batch_stats": new["batch_stats"]}
    want = fnn.BatchNorm(use_running_average=True, dtype=jnp.bfloat16).apply(variables, xj)
    got = tbn.eval()(tp.ncdhw(a).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_allclose(tp.ndhwc(got.detach().float()), np.asarray(want, np.float32),
                               atol=2e-2, rtol=1e-2)


def test_batchnorm_in_half_precision_backward_matches_flax():
    """Train-mode BatchNorm on a bf16 input with a bf16 cotangent: flax casts
    the input twice (for the statistics and where it centres it), so the
    input's gradient is two bf16 terms added in bf16; the port's is the
    same bits. The scale and bias gradients are fp32 sums."""
    rng = np.random.RandomState(2)
    a = (2.0 + 3.0 * rng.randn(2, 8, 8, 8, 8)).astype(np.float32)
    ct = rng.randn(*a.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.bfloat16)
    variables = tp.to_jax(tp.random_variables(bn, jnp.asarray(a), seed=2))

    def fn(params, x):
        return bn.apply(dict(variables, params=params), x, mutable=["batch_stats"])[0]

    _, vjp = jax.vjp(fn, variables["params"], jnp.asarray(a).astype(jnp.bfloat16))
    gparams, gx = vjp(jnp.asarray(ct).astype(jnp.bfloat16))
    tbn = BatchNorm3d(8).train()
    tbn.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"]))
    x = tp.ncdhw(a).to(BF16).requires_grad_()
    tbn(x).backward(tp.ncdhw(ct).to(BF16))
    assert x.grad.dtype == BF16
    np.testing.assert_array_equal(tp.ndhwc(x.grad.float()), np.asarray(gx, np.float32))
    np.testing.assert_allclose(tbn.bias.grad, gparams["bias"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.weight.grad, gparams["scale"], rtol=1e-5, atol=1e-6)
