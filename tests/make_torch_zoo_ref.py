"""Generate the JAX side of the G-gradient test in tests/test_torch_zoo.py,
so that the test needs no JAX gradient compile:
python tests/make_torch_zoo_ref.py

Writes tests/torch_zoo_ref.npz with JAX's fp32 generator objective
(xlstm_hved_tpu/engine/train.py) for U_HVEDNet3D at 32^3, D with kernel 3
and f_maps 8, on the numpy-drawn weights of tests/_torch_port.py (seed 8
for G, 9 for D), input and mask from RandomState(7), keep [1, 0, 1, 0],
the latent noise off (`reparametrize` patched to the mean), as
tests/test_torch_train.py sets up the flagship's:
- `grad.<port name>`: the gradient of every G parameter;
- `grad64.<port name>`: the same objective traced in float64
  (`jax.enable_x64`, the JAX modules' fp32 casts read as fp64 for that
  trace only, D in fp64), the witness the test holds both fp32 gradients
  to, as tests/test_torch_pretrain.py does: JAX's fp32 CPU gradient lies
  about a hundred times farther from it than the port's;
- `loss` and `losses.<term>`: the objective and its terms;
- `weights_l1`: the sum of |w| over the drawn G weights, which the test
  checks before it compares (the same draws on both sides).
32^3, not the 16^3 of the flagship's test: at 16^3 the deepest DRB output
is one voxel, the VU block's InstanceNorm of one voxel is an exact 0, and
the gradient of the whole deepest path vanishes; at 32^3 every level
carries gradient. Runs on the CPU backend with the test suite's settings,
in about two minutes.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.join(HERE, "torch_zoo_ref.npz")
NAME = "U_HVEDNet3D"
S = 32
KEEP = np.array([True, False, True, False])


def g_inputs():
    rng = np.random.RandomState(7)
    x = rng.rand(1, S, S, S, 4).astype(np.float32)
    mask = (rng.rand(1, S, S, S, 3) > 0.7).astype(np.float32)
    return x, mask


def g_variables():
    """(G, D) numpy-drawn JAX variables, and the G weights' sum of |w|."""
    import _torch_port as tp
    import xlstm_hved_tpu.models.hved as jax_hved
    from xlstm_hved_tpu.config import get_config

    x, _ = g_inputs()
    jmodel = jax_hved.HVEDFusionNet(get_config(NAME, use_pallas_mlstm=False))
    gvars = tp.random_variables(jmodel, jnp.asarray(x), seed=8, deterministic=True,
                                recon=True)
    dvars = tp.random_variables(jax_hved.Discriminator(f_maps=8, kernel=3),
                                jnp.asarray(np.zeros((1, S, S, S, 7), np.float32)), seed=9)
    l1 = sum(float(np.abs(v).astype(np.float64).sum())
             for v in jax.tree_util.tree_leaves(gvars["params"]))
    return gvars, dvars, l1


class _F64Numpy:
    """`jax.numpy` with `float32` read as `float64`."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_g_gradient(gvars, dvars, x64=False):
    """(loss, {term: value}, {port name: gradient}) of JAX's generator
    objective, in fp32, or in fp64 with `x64`."""
    import _torch_port as tp
    import xlstm_hved_tpu.models.hved as jax_hved
    from xlstm_hved_tpu import losses as jl
    from xlstm_hved_tpu.config import TrainConfig, get_config
    from xlstm_hved_tpu.engine import train as jtrain
    from xlstm_hved_tpu.nn import blocks as jblocks
    from xlstm_hved_torch.utils.convert import _flatten, _param

    jmodel = jax_hved.HVEDFusionNet(get_config(NAME, use_pallas_mlstm=False))
    jdisc = jax_hved.Discriminator(f_maps=8, kernel=3,
                                   dtype=jnp.float64 if x64 else jnp.float32)
    x, mask = g_inputs()
    dt = np.float64 if x64 else np.float32
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dt)), t)
    modules = (jax_hved, jblocks, jl)
    saved = {m: m.jnp for m in modules}
    saved_rep = jax_hved.reparametrize
    jax_hved.reparametrize = lambda key, mu, lv, deterministic=False: mu
    try:
        with jax.enable_x64(x64):
            if x64:
                for m in modules:
                    m.jnp = _F64Numpy()
            state = jtrain.TrainState(step=0, params_g=cast(gvars["params"]),
                                      batch_stats_g=cast(gvars.get("batch_stats", {})),
                                      opt_state_g=None, params_d=cast(dvars["params"]),
                                      opt_state_d=None)
            loss_g_fn = jtrain._build_loss_g(jmodel, jdisc, TrainConfig(crop_size=(S,) * 3))
            fn = jax.jit(lambda s, x, m, k: jax.value_and_grad(loss_g_fn, has_aux=True)(
                s.params_g, s, x, m, k, jax.random.PRNGKey(1), jax.random.PRNGKey(2)))
            (loss, aux), grads = fn(state, jnp.asarray(x, dt), jnp.asarray(mask, dt),
                                    jnp.asarray(KEEP))
            grads = jax.tree.map(lambda g: np.asarray(g), jax.device_get(grads))
            assert all(g.dtype == dt for g in jax.tree_util.tree_leaves(grads))
            losses = {k: float(v) for k, v in aux["losses"].items()}
            loss = float(loss)
    finally:
        jax_hved.reparametrize = saved_rep
        for m, v in saved.items():
            m.jnp = v
    grads = dict(_param(path, g) for path, g in _flatten(grads).items())
    return loss, losses, grads


def main():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    gvars, dvars, l1 = g_variables()
    loss, losses, grads = jax_g_gradient(gvars, dvars)
    _, _, grads64 = jax_g_gradient(gvars, dvars, x64=True)
    out = {"loss": np.float64(loss), "weights_l1": np.float64(l1)}
    out.update({f"losses.{k}": np.float64(v) for k, v in losses.items()})
    out.update({f"grad.{k}": v.astype(np.float32) for k, v in grads.items()})
    out.update({f"grad64.{k}": v.astype(np.float64) for k, v in grads64.items()})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: loss {loss:.6f}, {len(grads)} gradients")


if __name__ == "__main__":
    main()
