"""Generate the JAX side of tests/test_torch_precision.py, so that the test
needs no JAX compile: python tests/make_torch_precision_ref.py

Writes tests/torch_precision_ref.npz with
- `golden.<collection>.<flax path>`: the weights of the stored forward
  goldens (tests/goldens/XLSTM_HVED.npz and XLSTM_HVED_bf16.npz), from the
  one jitted `model.init` of tests/make_goldens.py::_init;
- the G gradient: the generator objective of xlstm_hved_tpu/engine/train.py
  at 16^3 (XLSTM_HVED; D with kernel 3 and f_maps 8) on the numpy-drawn
  weights of tests/_torch_port.py (seed 8 for G, 9 for D), input
  RandomState(7), keep [1, 0, 1, 0], the latent noise off (`reparametrize`
  patched to the mean), as tests/test_torch_train.py sets it up.
  `gweights.<collection>.<flax path>` and `dweights.params.<flax path>` hold
  those weights, so that chip_smoke.py repeats the gradient on the card
  without JAX; `grad.bf16.<port name>` JAX's bf16 G gradient (G and D in
  bf16); `grad.dist` the L2 distance of JAX's bf16 G gradient from its fp32
  one over all parameters at once; `grad.rel_l2.<port name>` the same per
  parameter, relative to the fp32 gradient, and `grad.rel_l2_all` over all
  parameters; `grad.loss.<dtype>` the two losses;
- `block.<case>.*`: one block's bf16 backward (BLOCK_CASES: an encoder
  stage, a block-diagonal encoder stage, a seg decoder stage) on
  numpy-drawn weights (`block.<case>.params.<flax path>`, seed 3), inputs
  RandomState(10 + i) and output cotangents RandomState(50 + i):
  `block.<case>.bf16.<port name or input<i>>` JAX's bf16 gradients (inputs
  NCDHW), `block.<case>.dist` their L2 distance from the fp32 ones over all
  of them at once;
- `forward32.<head>.<stat>`: JAX's bf16-vs-fp32 forward distance on the
  goldens' weights at 32^3 (input RandomState(7) of (1, 32, 32, 32, 4), all
  modalities, deterministic latents): max, mean and 99.9th percentile of
  |d| for seg and recon, and max|recon| of the fp32 forward. chip_smoke.py
  phase 9 bounds the port's bf16 forward at 128^3 with these (the mean and
  the percentile barely move from 32^3 to 64^3, the max grows with the
  voxel count).
Runs on the CPU backend with the test suite's settings; takes a few minutes.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import PRECISION_KEEP, precision_g_inputs  # noqa: E402

OUT = os.path.join(HERE, "torch_precision_ref.npz")
S = 16
KEEP = np.array(PRECISION_KEEP)
# case -> NDHWC input shapes
BLOCK_CASES = {"encoder": [(1, 8, 8, 8, 4)], "block_diag": [(1, 8, 8, 8, 12)],
               "decoder": [(1, 8, 8, 8, 4), (1, 4, 4, 4, 8)]}


# x, mask as tests/test_torch_train.py draws them (S = 16)
g_inputs = precision_g_inputs


def block_inputs(case):
    return [np.random.RandomState(10 + i).randn(*shape).astype(np.float32)
            for i, shape in enumerate(BLOCK_CASES[case])]


def block_cotangent(i, shape):
    """The cotangent of a block's i-th output, NDHWC `shape`."""
    return np.random.RandomState(50 + i).randn(*shape).astype(np.float32)


def jax_block(case, dtype):
    from xlstm_hved_tpu.nn import blocks as jb

    return {"encoder": lambda: jb.EncoderStage(8, order="ilc", dtype=dtype),
            "block_diag": lambda: jb.BlockDiagEncoderStage(4, 5, apply_pooling=True,
                                                           dtype=dtype),
            "decoder": lambda: jb.DecoderStage(4, order="ilc", rsm=True, mvae=True,
                                               dtype=dtype)}[case]()


def g_variables():
    """(G, D) numpy-drawn JAX variables of the G gradient."""
    import _torch_port as tp
    import xlstm_hved_tpu.models.hved as jax_hved
    from xlstm_hved_tpu.config import get_config

    x, _ = g_inputs()
    jmodel = jax_hved.HVEDFusionNet(get_config("XLSTM_HVED", use_pallas_mlstm=False))
    gvars = tp.random_variables(jmodel, jnp.asarray(x), seed=8, deterministic=True,
                                recon=True)
    dvars = tp.random_variables(jax_hved.Discriminator(f_maps=8, kernel=3),
                                jnp.asarray(np.zeros((1, S, S, S, 7), np.float32)), seed=9)
    return gvars, dvars


def jax_g_gradient(compute_dtype, gvars, dvars):
    """(loss, {port name: gradient}) of JAX's generator objective with G in
    `compute_dtype` and D in the same dtype."""
    import xlstm_hved_tpu.models.hved as jax_hved
    from xlstm_hved_tpu.config import TrainConfig, get_config
    from xlstm_hved_tpu.engine import train as jtrain
    from xlstm_hved_torch.utils.convert import params_from_jax

    import _torch_port as tp

    jmodel = jax_hved.HVEDFusionNet(get_config("XLSTM_HVED", compute_dtype=compute_dtype,
                                               use_pallas_mlstm=False))
    dt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    jdisc = jax_hved.Discriminator(f_maps=8, kernel=3, dtype=dt)
    x, mask = g_inputs()
    state = jtrain.TrainState(step=0, params_g=tp.to_jax(gvars["params"]),
                              batch_stats_g=tp.to_jax(gvars["batch_stats"]), opt_state_g=None,
                              params_d=tp.to_jax(dvars["params"]), opt_state_d=None)
    saved = jax_hved.reparametrize
    jax_hved.reparametrize = lambda key, mu, lv, deterministic=False: mu
    try:
        loss_g_fn = jtrain._build_loss_g(jmodel, jdisc, TrainConfig(crop_size=(S,) * 3))
        fn = jax.jit(lambda s, x, m, k: jax.value_and_grad(loss_g_fn, has_aux=True)(
            s.params_g, s, x, m, k, jax.random.PRNGKey(1), jax.random.PRNGKey(2)))
        (loss, _), grads = fn(state, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(KEEP))
    finally:
        jax_hved.reparametrize = saved
    grads = {k: v.numpy().astype(np.float64)
             for k, v in params_from_jax(jax.device_get(grads)).items()}
    return float(loss), grads


def jax_block_gradients(case, variables, compute_dtype):
    """{port name or input<i>: gradient} of one block's output against the
    seeded cotangents, the block and its inputs in `compute_dtype`."""
    from xlstm_hved_torch.utils.convert import params_from_jax

    dt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    module = jax_block(case, jnp.bfloat16 if compute_dtype == "bfloat16" else None)
    xs = [jnp.asarray(a).astype(dt) for a in block_inputs(case)]

    def fn(params, *xs):
        out = module.apply(dict(variables, params=params), *xs)
        return out if isinstance(out, tuple) else (out,)

    outs, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, variables["params"]), *xs)
    grads = vjp(tuple(jnp.asarray(block_cotangent(i, o.shape)).astype(o.dtype)
                      for i, o in enumerate(outs)))
    out = {k: v.numpy().astype(np.float64)
           for k, v in params_from_jax(jax.device_get(grads[0])).items()}
    for i, g in enumerate(grads[1:]):
        out[f"input{i}"] = np.moveaxis(np.asarray(g.astype(jnp.float32), np.float64), -1, 1)
    return out


def rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


def flat(grads):
    return np.concatenate([np.ravel(grads[n]) for n in sorted(grads)])


def flatten(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + ".".join(str(p.key) for p in path)] = np.asarray(leaf, np.float32)
    return out


FORWARD_S = 32


def forward_input(n=FORWARD_S):
    return np.random.RandomState(7).rand(1, n, n, n, 4).astype(np.float32)


def distances(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"max": float(d.max()), "mean": float(d.mean()),
            "p999": float(np.quantile(d, 0.999))}


def jax_forward_distances(variables):
    """JAX's bf16-vs-fp32 seg and recon distances at FORWARD_S^3."""
    from xlstm_hved_tpu.models import find_model_using_name

    x = jnp.asarray(forward_input())
    outs = {}
    for dtype in ("float32", "bfloat16"):
        model = find_model_using_name("XLSTM_HVED", compute_dtype=dtype)
        out = jax.jit(lambda v, x, m=model: m.apply(v, x, recon=True, deterministic=True))(
            variables, x)
        outs[dtype] = {"seg": np.asarray(out.seg), "recon": np.asarray(out.recon)}
    res = {f"forward32.{head}.{k}": np.float64(v) for head in ("seg", "recon")
           for k, v in distances(outs["bfloat16"][head], outs["float32"][head]).items()}
    res["forward32.recon.top"] = np.float64(np.abs(outs["float32"]["recon"]).max())
    return res


def main():
    import _torch_port as tp
    from make_goldens import _init

    _, _, variables = _init("XLSTM_HVED")
    arrays = {}
    for col in ("params", "batch_stats"):
        arrays.update(flatten(jax.device_get(variables[col]), f"golden.{col}."))
    arrays.update(jax_forward_distances(variables))

    gvars, dvars = g_variables()
    for col in ("params", "batch_stats"):
        arrays.update(flatten(gvars[col], f"gweights.{col}."))
    arrays.update(flatten(dvars["params"], "dweights.params."))
    loss32, g32 = jax_g_gradient("float32", gvars, dvars)
    loss16, g16 = jax_g_gradient("bfloat16", gvars, dvars)
    for name in g32:
        arrays[f"grad.rel_l2.{name}"] = np.float64(rel_l2(g16[name], g32[name]))
        arrays[f"grad.bf16.{name}"] = g16[name].astype(np.float32)
    arrays["grad.rel_l2_all"] = np.float64(rel_l2(flat(g16), flat(g32)))
    arrays["grad.dist"] = np.float64(np.linalg.norm(flat(g16) - flat(g32)))
    arrays["grad.loss.float32"] = np.float64(loss32)
    arrays["grad.loss.bfloat16"] = np.float64(loss16)

    report = []
    for case, shapes in BLOCK_CASES.items():
        bvars = tp.random_variables(jax_block(case, None),
                                    *[jnp.asarray(a) for a in block_inputs(case)], seed=3)
        arrays.update(flatten(bvars["params"], f"block.{case}.params."))
        b32 = jax_block_gradients(case, bvars, "float32")
        b16 = jax_block_gradients(case, bvars, "bfloat16")
        arrays.update({f"block.{case}.bf16.{k}": v.astype(np.float32) for k, v in b16.items()})
        arrays[f"block.{case}.dist"] = np.float64(np.linalg.norm(flat(b16) - flat(b32)))
        report.append(f"{case} {rel_l2(flat(b16), flat(b32)):.3e}")

    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: loss fp32 {loss32:.6f} bf16 {loss16:.6f}; G gradient bf16 vs fp32 "
          f"rel L2 over all {float(arrays['grad.rel_l2_all']):.3e}; blocks' bf16 vs fp32 "
          f"gradients rel L2: {', '.join(report)}; "
          + ", ".join(f"{k} {float(v):.4g}" for k, v in arrays.items()
                      if k.startswith("forward32.")))


if __name__ == "__main__":
    # tests/conftest.py's settings, before any JAX operation
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_default_matmul_precision", "highest")
    main()
