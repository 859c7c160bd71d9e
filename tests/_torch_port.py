"""Shared set-up for the tests that hold the PyTorch port (`xlstm_hved_torch`)
against the JAX package on the same weights and inputs.

JAX weights come from `jax.eval_shape` of `module.init` (no jitted init),
with every leaf then drawn from numpy: conv and dense weights
~ N(0, 1/fan_in) with |w| floored at 0.3 sigma (a near-zero channel ahead of
an InstanceNorm would amplify fp32 rounding into the comparison), biases
~ N(0, 0.05), norm scales near 1, BatchNorm statistics well away from 0.
The same arrays go to the port through `params_from_jax`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from xlstm_hved_tpu.models import find_model_using_name as jax_model
from xlstm_hved_torch.models import find_model_using_name
from xlstm_hved_torch.utils.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
# Under pytest-xdist the workers share the machine's cores: each worker's
# torch takes its share of them, so that the workers' OpenMP pools do not
# oversubscribe the cores (spinning threads, each file many times slower).
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
torch.backends.cudnn.allow_tf32 = False

RNGS = {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)}


def _fan_in(name, shape):
    if name == "kernel":
        if len(shape) == 6:
            return int(np.prod(shape[1:5]))
        return int(np.prod(shape[:-1]))
    return int(shape[-1])  # LinearHeadwiseExpand (NH, out_d, in_d)


def _draw(rng, path, shape):
    name = path[-1]
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name == "mean":
        return 0.05 * rng.randn(*shape)
    if name == "kernel" or (name == "weight" and len(shape) == 3):
        fan_in = _fan_in(name, shape)
        w = rng.randn(*shape) / np.sqrt(fan_in)
        return np.sign(w) * np.maximum(np.abs(w), 0.3 / np.sqrt(fan_in))
    if name in ("scale", "learnable_skip"):
        return 1.0 + 0.05 * rng.randn(*shape)
    if name == "alpha":
        return np.full(shape, 0.25)
    return 0.05 * rng.randn(*shape)  # biases and (1 + w) norm offsets


def random_variables(module, *args, seed=0, **kwargs):
    """Numpy-filled variables with the structure `module.init` would give."""
    shapes = jax.eval_shape(lambda: module.init(RNGS, *args, **kwargs))
    rng = np.random.RandomState(seed)
    out = {}
    for col, tree in shapes.items():
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        leaves = [_draw(rng, tuple(k.key for k in path), s.shape).astype(np.float32)
                  for path, s in flat]
        out[col] = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree), leaves)
    return out


def load_port(torch_module, variables):
    """Load JAX variables into a port module (strict) and put it in eval mode."""
    sd = params_from_jax(variables["params"], variables.get("batch_stats"))
    torch_module.load_state_dict(sd, strict=True)
    return torch_module.eval()


def model_pair(name, seed=0, shape=(1, 32, 32, 32, 4), **overrides):
    """(port model on the CPU, jitted JAX forward(variables, x, keep) with
    recon and deterministic latents, JAX variables, NDHWC input) for one zoo
    preset with its config fields `overrides`, both holding the same
    numpy-drawn weights."""
    jm = jax_model(name, compute_dtype="float32", use_pallas_mlstm=False, **overrides)
    x = np.random.RandomState(42).rand(*shape).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=seed, deterministic=True,
                                 recon=True)
    tm = load_port(find_model_using_name(name, device="cpu", **overrides), variables)
    fwd = jax.jit(lambda v, x, keep: jm.apply(v, x, keep=keep, recon=True,
                                             deterministic=True))
    return tm, fwd, to_jax(variables), x


def to_jax(variables):
    return jax.tree.map(jnp.asarray, variables)


def ncdhw(a):
    """NDHWC numpy -> NCDHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def ndhwc(t):
    """NCDHW torch (or numpy) -> NDHWC numpy."""
    return np.moveaxis(np.asarray(t), 1, -1)


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def jax_param_zeros(name, size=16, **overrides):
    """A zoo preset's flax parameter tree at a size^3 input, zeros of the
    shapes `jax.eval_shape` of its init gives (nothing compiles)."""
    model = jax_model(name, compute_dtype="float32", use_pallas_mlstm=False, **overrides)
    x = jnp.zeros((1, size, size, size, 4))
    shapes = jax.eval_shape(lambda: model.init(RNGS, x, deterministic=True, recon=True))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])


_LEAF = {"kernel": "weight", "scale": "weight", "alpha": "weight"}


def torch_param_name(keystr):
    """A flax leaf path, as jax.tree_util.keystr prints it, -> the port's
    parameter name (utils/convert.py's naming)."""
    keys = [k.strip("'") for k in keystr.strip("[]").split("][")]
    return ".".join(keys[:-1] + [_LEAF.get(keys[-1], keys[-1])])
