"""The JAX side of the training chain's K-step checks, and its generator:

    python tests/make_torch_protocol_ref.py

The chain is the protocol's: the pretrain net (XLSTM_HVED's config with
`shared_recon=False`) for CHAIN_K_PRE pretrain steps with the seg decoders
frozen, `surgical_restore` into the flagship, CHAIN_K_FT G+D steps with
Discriminator(CHAIN_DISC), then one evaluation step (chip_smoke.py's
CHAIN_* settings, tests/_torch_chain.py). `jax_chain` runs it through JAX's own builders
(`make_pretrain_step`, `surgical_restore`, `make_train_step`,
`make_eval_step`) with the draws that differ only by their RNG stream
pinned for that trace alone: the subset of each step from a fixed list
(`sample_subset_index` replaced by a lookup of the step's key), the latents
at their means (`reparametrize` replaced), the instance-missing drop one
fixed mask. Its record has `run_chain`'s layout and the port's
parameter names.

Writes tests/torch_protocol_ref.npz:
- `pre.<collection>.<flax path>`, `flag.<collection>.<flax path>` and
  `disc.params.<flax path>`: the chain's weights, as JAX's
  `create_train_state(..., init_scheme="reference")` draws them (the pretrain
  net at key PRE_KEY, the flagship and D at FT_KEY; the rbg generator, as
  tests/test_torch_train.py's init check uses, for half the compile time;
  the shapes do not depend on the crop);
- `settings.*`: the chain's settings and a checksum of its batches
  (`settings_arrays`);
- the reference of chip_smoke.py's phase 15 at CHAIN_CROP on the CPU:
  `<run>.<phase>.losses` and `<run>.ft.eval` for run `jax32` (JAX fp32),
  `jax16` (JAX with G and D in bf16), `cpu32` (the port, fp32) and `cpu16`
  (the port, G and D in bf16);
  `cpu32.<phase>.<delta_g|delta_d>.<port name>` the port's updates;
  `jaxbf16.<phase>.loss_rel` (per loss term, the largest relative difference
  over the steps) and `jaxbf16.<phase>.<vector>` (relative L2) of JAX's bf16
  chain from its fp32 chain; `cpubf16.*` the same for the port's bf16 chain
  from its fp32 chain; `cpujax.*` for the port's fp32 chain from JAX's.
Runs on the CPU backend with the test suite's settings; about 10 minutes.
"""
import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_chain as tc  # noqa: E402
import chip_smoke as cs  # noqa: E402

OUT = os.path.join(HERE, "torch_protocol_ref.npz")
PRE_KEY, FT_KEY = 1, 2
DRAW_CROP = (16, 16, 16)
# the steps' keys: pretrain step i takes PRNGKey(i), finetune step i PRNGKey(100 + i)
FT_KEY_BASE = 100


def _jax_models(compute_dtype, disc_dtype=None):
    import xlstm_hved_tpu.models.hved as jax_hved
    from xlstm_hved_tpu.config import get_config

    kw = dict(compute_dtype=compute_dtype, use_pallas_mlstm=False)
    pre = jax_hved.HVEDFusionNet(get_config(tc.CHAIN_MODEL, shared_recon=False, **kw))
    flag = jax_hved.HVEDFusionNet(get_config(tc.CHAIN_MODEL, **kw))
    if disc_dtype is None:
        disc_dtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    disc = jax_hved.Discriminator(f_maps=tc.CHAIN_DISC[0], kernel=tc.CHAIN_DISC[1],
                                  dtype=disc_dtype)
    return pre, flag, disc


def draw_weights():
    """{"pre": {"params", "batch_stats"}, "flag": {...}, "disc": {"params"}}
    as numpy trees, from JAX's create_train_state with the reference init."""
    from xlstm_hved_tpu.config import TrainConfig
    from xlstm_hved_tpu.engine import train as jtrain

    from concurrent.futures import ThreadPoolExecutor

    pre, flag, disc = _jax_models("float32")
    cfg = TrainConfig(crop_size=DRAW_CROP, num_epochs=tc.CHAIN_EPOCHS)
    sample = jnp.zeros((1, *DRAW_CROP, 4), jnp.float32)

    def draw(model, key):   # the two draws compile beside each other
        with jax.default_prng_impl("rbg"):
            state, _ = jtrain.create_train_state(
                model, disc, cfg, jax.random.PRNGKey(key), sample,
                tc.CHAIN_STEPS_PER_EPOCH, init_scheme="reference")
        return jax.device_get(state)

    with ThreadPoolExecutor(2) as pool:
        pre_state, flag_state = pool.map(draw, (pre, flag), (PRE_KEY, FT_KEY))
    out = {"pre": {"params": pre_state.params_g, "batch_stats": pre_state.batch_stats_g},
           "flag": {"params": flag_state.params_g, "batch_stats": flag_state.batch_stats_g},
           "disc": {"params": flag_state.params_d}}
    return jax.tree.map(np.asarray, out)


def settings_arrays():
    """The chain's settings and a checksum of its batches at CHAIN_CROP, as
    stored beside the reference (`settings.*`), so that a stale reference
    shows."""
    batch_sum = sum(float(np.sum(x, dtype=np.float64)) + float(np.sum(m, dtype=np.float64))
                    for x, m in tc.chain_batches(tc.CHAIN_CROP))
    return {"settings.crop": np.asarray(tc.CHAIN_CROP),
            "settings.steps": np.asarray([tc.CHAIN_K_PRE, tc.CHAIN_K_FT,
                                          tc.CHAIN_STEPS_PER_EPOCH, tc.CHAIN_EPOCHS]),
            "settings.subsets": np.asarray(tc.CHAIN_PRE_SUBSETS + tc.CHAIN_FT_SUBSETS),
            "settings.eval_drop": np.asarray(tc.CHAIN_EVAL_DROP),
            "settings.disc": np.asarray(tc.CHAIN_DISC),
            "settings.batch_sum": np.float64(batch_sum)}


def flatten(tree, prefix):
    return {prefix + ".".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def weight_arrays(weights):
    arrays = {}
    for name, cols in weights.items():
        for col, tree in cols.items():
            arrays.update(flatten(tree, f"{name}.{col}."))
    return arrays


def weights_from_npz(ref):
    return {name: {col: tree for col, tree in cs.npz_tree(ref, name).items()}
            for name in ("pre", "flag", "disc")}


def _step_keys():
    pre = [jax.random.PRNGKey(i) for i in range(tc.CHAIN_K_PRE)]
    ft = [jax.random.PRNGKey(FT_KEY_BASE + i) for i in range(tc.CHAIN_K_FT)]
    return pre, ft


@contextlib.contextmanager
def pinned_jax_draws():
    """Inside, JAX's pretrain and train steps take the pinned subsets (the
    subset key each step splits off its own key, looked up in a table of the
    chain's keys) and the latents at their means."""
    import xlstm_hved_tpu.models.hved as jax_hved
    from xlstm_hved_tpu.engine import train as jtrain

    pre_keys, ft_keys = _step_keys()
    table = np.stack([np.asarray(jax.random.split(k)[0]) for k in pre_keys]
                     + [np.asarray(jax.random.split(k, 3)[0]) for k in ft_keys])
    seq = np.asarray(tc.CHAIN_PRE_SUBSETS + tc.CHAIN_FT_SUBSETS, np.int32)

    def sample_subset_index(key, min_size=1, max_size=3):
        hit = jnp.all(key[None] == jnp.asarray(table), axis=-1)
        return jnp.sum(jnp.where(hit, jnp.asarray(seq), 0)).astype(jnp.int32)

    saved = jtrain.sample_subset_index, jax_hved.reparametrize
    jtrain.sample_subset_index = sample_subset_index
    jax_hved.reparametrize = lambda key, mu, logvar, deterministic=False: mu
    try:
        yield
    finally:
        jtrain.sample_subset_index, jax_hved.reparametrize = saved


def _port(tree):
    """A flax tree as {port name: numpy array} in the port's layouts, in its
    own dtype."""
    from xlstm_hved_torch.utils.convert import _flatten, _param

    return dict(_param(path, np.asarray(leaf))
                for path, leaf in _flatten(jax.device_get(tree)).items())


def _adam(opt_state):
    import optax

    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(states) == 1
    return _port(states[0].mu), _port(states[0].nu)


def _bn(batch_stats):
    from xlstm_hved_torch.utils.convert import _flatten

    names = {"mean": "running_mean", "var": "running_var"}
    return {".".join((*path[:-1], names[path[-1]])): np.asarray(leaf)
            for path, leaf in _flatten(jax.device_get(batch_stats)).items()}


def _sub(a, b):
    return {k: a[k] - b[k] for k in a}


def jax_chain(weights, batches, compute_dtype="float32", disc_dtype=None, evaluate=True):
    """The chain through JAX's builders, from the numpy trees `weights`, on
    the NCDHW numpy `batches` of tc.chain_batches (G in `compute_dtype`, D
    in `disc_dtype`, by default the same), and with `evaluate` its
    evaluation step. The compiles of the steps run beside each other.
    Returns run_chain's record."""
    from concurrent.futures import ThreadPoolExecutor

    from xlstm_hved_tpu.config import TrainConfig
    from xlstm_hved_tpu.engine import train as jtrain
    from xlstm_hved_tpu.engine.checkpoint import surgical_restore

    pre, flag, disc = _jax_models(compute_dtype, disc_dtype)
    ndhwc = [tuple(jnp.asarray(np.moveaxis(a, 1, -1)) for a in b) for b in batches]
    crop = ndhwc[0][0].shape[1:4]
    cfg = TrainConfig(crop_size=crop, num_epochs=tc.CHAIN_EPOCHS)
    tx = jtrain.make_optimizer(cfg, tc.CHAIN_STEPS_PER_EPOCH)
    pre_keys, ft_keys = _step_keys()
    j = lambda t: jax.tree.map(jnp.asarray, t)
    drop = jnp.asarray(np.asarray(tc.CHAIN_EVAL_DROP))

    def pre_state():
        p = j(weights["pre"]["params"])
        return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=p,
                                 batch_stats_g=j(weights["pre"]["batch_stats"]),
                                 opt_state_g=tx.init(p), params_d={}, opt_state_d=None)

    def ft_state(params_g):
        d = j(weights["disc"]["params"])
        return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=params_g,
                                 batch_stats_g=j(weights["flag"]["batch_stats"]),
                                 opt_state_g=tx.init(params_g), params_d=d,
                                 opt_state_d=tx.init(d))

    with pinned_jax_draws():
        freeze = jtrain.freeze_mask_for(weights["pre"]["params"], ("sdecoder",))
        pre_step = jtrain.make_pretrain_step(pre, cfg, tc.CHAIN_STEPS_PER_EPOCH,
                                             freeze_mask=freeze)
        train_step = jtrain.make_train_step(flag, disc, cfg, tc.CHAIN_STEPS_PER_EPOCH)
        eval_step = jtrain.make_eval_step(flag)
        x_eval, mask_eval = ndhwc[-1]
        x_missing = jnp.where(drop, 0.0, x_eval)
        flag_params = j(weights["flag"]["params"])
        # traced one after another (the patches are module state), compiled
        # beside each other
        lowered = [pre_step.lower(pre_state(), ndhwc[0][0], pre_keys[0]),
                   train_step.lower(ft_state(flag_params), *ndhwc[tc.CHAIN_K_PRE], ft_keys[0])]
        if evaluate:
            lowered.append(eval_step.lower(flag_params, j(weights["flag"]["batch_stats"]),
                                           x_eval, x_missing, mask_eval))
        with ThreadPoolExecutor(len(lowered)) as pool:
            pre_c, train_c, *eval_c = pool.map(lambda low: low.compile(), lowered)

    record = {}
    state, losses = pre_state(), []
    for i in range(tc.CHAIN_K_PRE):
        state, metrics = pre_c(state, ndhwc[i][0], pre_keys[i])
        losses.append([float(metrics[k]) for k in tc.PRE_LOSS_KEYS])
    mu, nu = _adam(state.opt_state_g)
    record["pre"] = dict(losses=np.array(losses), mu_g=mu, nu_g=nu,
                         delta_g=_sub(_port(state.params_g), _port(weights["pre"]["params"])),
                         bn=_sub(_bn(state.batch_stats_g), _bn(weights["pre"]["batch_stats"])))

    merged, loaded, skipped = surgical_restore(j(weights["flag"]["params"]), state.params_g)
    theta0 = _port(jax.tree.map(np.array, merged))   # the steps donate their state
    state, losses = ft_state(merged), []
    for i in range(tc.CHAIN_K_FT):
        x, mask = ndhwc[tc.CHAIN_K_PRE + i]
        state, metrics = train_c(state, x, mask, ft_keys[i])
        losses.append([float(metrics[k]) for k in tc.FT_LOSS_KEYS])
    mu_g, nu_g = _adam(state.opt_state_g)
    mu_d, nu_d = _adam(state.opt_state_d)
    record["ft"] = dict(
        losses=np.array(losses), mu_g=mu_g, nu_g=nu_g, mu_d=mu_d, nu_d=nu_d,
        delta_g=_sub(_port(state.params_g), theta0),
        delta_d=_sub(_port(state.params_d), _port(weights["disc"]["params"])),
        bn=_sub(_bn(state.batch_stats_g), _bn(weights["flag"]["batch_stats"])))
    if evaluate:
        metrics = eval_c[0](state.params_g, state.batch_stats_g, x_eval, x_missing, mask_eval)
        record["ft"]["eval"] = np.array([float(metrics[k]) for k in tc.CHAIN_EVAL_KEYS])
    record["surgery"] = (loaded, skipped)
    return record


class _F64Numpy:
    """`jax.numpy` with `float32` read as `float64`."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def jax_chain_fp64(weights, batches):
    """`jax_chain` in float64: `jax.enable_x64`, and the fp32 casts of the
    JAX modules on the chain's path read as fp64 for this trace alone (as
    tests/test_torch_pretrain.py runs its objective in fp64)."""
    import xlstm_hved_tpu.models.hved as jax_hved
    from xlstm_hved_tpu import losses, metrics
    from xlstm_hved_tpu.nn import blocks, vil
    from xlstm_hved_tpu.ops import mlstm

    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax.enable_x64(True))
        for module in (jax_hved, mlstm, vil, blocks, losses, metrics):
            stack.callback(setattr, module, "jnp", module.jnp)
            module.jnp = _F64Numpy()
        return jax_chain(f64(weights), [tuple(a.astype(np.float64) for a in b) for b in batches],
                         disc_dtype=jnp.float64)


def distance_arrays(dist, prefix):
    arrays = {f"{prefix}.eval_rel": np.float64(dist["eval_rel"])}
    for phase, names in tc.CHAIN_VECTORS.items():
        arrays[f"{prefix}.{phase}.loss_rel"] = np.asarray(dist[phase]["loss_rel"], np.float64)
        for name in names:
            arrays[f"{prefix}.{phase}.{name}"] = np.float64(dist[phase][name]["rel_l2"])
    return arrays


def main():
    import torch

    weights = draw_weights()
    arrays = weight_arrays(weights)
    arrays.update(settings_arrays())
    batches = tc.chain_batches(tc.CHAIN_CROP)
    runs = {"jax32": jax_chain(weights, batches, "float32"),
            "jax16": jax_chain(weights, batches, "bfloat16")}
    port_weights = tc.chain_weights(_NpzLike(arrays))
    runs["cpu32"] = tc.run_chain(torch.device("cpu"), port_weights, batches)
    runs["cpu16"] = tc.run_chain(torch.device("cpu"), port_weights, batches,
                                 compute_dtype="bfloat16", disc_dtype="bfloat16")
    for run, rec in runs.items():
        for phase in ("pre", "ft"):
            arrays[f"{run}.{phase}.losses"] = rec[phase]["losses"]
        arrays[f"{run}.ft.eval"] = rec["ft"]["eval"]
    for phase, names in (("pre", ("delta_g",)), ("ft", ("delta_g", "delta_d"))):
        for name in names:
            for k, v in runs["cpu32"][phase][name].items():
                arrays[f"cpu32.{phase}.{name}.{k}"] = v.astype(np.float32)
    bf16 = tc.chain_distances(runs["jax16"], runs["jax32"])
    port_bf16 = tc.chain_distances(runs["cpu16"], runs["cpu32"])
    port = tc.chain_distances(runs["cpu32"], runs["jax32"])
    arrays.update(distance_arrays(bf16, "jaxbf16"))
    arrays.update(distance_arrays(port_bf16, "cpubf16"))
    arrays.update(distance_arrays(port, "cpujax"))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}")
    for label, dist in (("JAX bf16 from JAX fp32", bf16), ("port bf16 from port fp32", port_bf16),
                        ("port fp32 from JAX fp32", port)):
        print(f"{label} at {tc.CHAIN_CROP}:")
        for line in tc.describe_distances(dist):
            print("  " + line)


class _NpzLike(dict):
    """A dict of arrays read as np.load's result (`files`, item access)."""

    @property
    def files(self):
        return list(self)


if __name__ == "__main__":
    # tests/conftest.py's settings, before any JAX operation
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_default_matmul_precision", "highest")
    main()
