"""The protocol's training chain over K steps, the code shared by its checks:
tests/test_torch_protocol_parity.py and tests/test_torch_protocol_parity_fp64.py
hold the port's chain to the JAX package's on the CPU,
tests/make_torch_protocol_ref.py stores JAX's weights and chains for the
card, and chip_smoke.py's phase 15 runs it on the card. Imports no JAX.

The chain: the pretrain net (CHAIN_MODEL's config, `shared_recon=False`)
takes CHAIN_K_PRE pretrain steps with its seg decoders frozen, is grafted
into the flagship by `surgical_restore`, and the flagship and D take
CHAIN_K_FT G+D steps; one evaluation step with a fixed instance-missing drop
closes it. `run_chain` drives it through the port's own builders.
"""
from __future__ import annotations

import contextlib
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))

CHAIN_REF = os.path.join(HERE, "torch_protocol_ref.npz")
CHAIN_MODEL = "XLSTM_HVED"    # the protocol's --model_name; pretrain adds shared_recon=False
CHAIN_K_PRE, CHAIN_K_FT = 6, 6
# two steps an epoch over three epochs: the poly learning rate steps down at
# steps 2 and 4 of each phase (1e-4, then 0.694 and 0.372 of it)
CHAIN_STEPS_PER_EPOCH, CHAIN_EPOCHS = 2, 3
# the pinned subset draws (every size 1-3) and the instance-missing drop
CHAIN_PRE_SUBSETS = (0, 5, 11, 3, 8, 12)
CHAIN_FT_SUBSETS = (2, 9, 10, 4, 7, 13)
CHAIN_EVAL_DROP = (False, True, False, True)
CHAIN_DISC = (8, 3)           # Discriminator f_maps, kernel
CHAIN_CROP = (64, 96, 64)     # phase 15: the JAX r5 recipe's crop (ViL S 768)
CHAIN_BATCH_SEED = 15
PRE_LOSS_KEYS = ("loss", "recon", "kld")
FT_LOSS_KEYS = ("loss", "dice", "m_dice", "recon", "kld", "g_gan", "loss_d")
CHAIN_EVAL_KEYS = ("vloss", "dice", "wt_dice", "tc_dice", "ec_dice", "wt_dice_m",
                   "tc_dice_m", "ec_dice_m", "psnr_f", "psnr_m")
# the vectors compared after each phase: the update of the parameters, Adam's
# two moments, the movement of the BatchNorm running statistics
CHAIN_VECTORS = {"pre": ("delta_g", "mu_g", "nu_g", "bn"),
                 "ft": ("delta_g", "mu_g", "nu_g", "bn", "delta_d", "mu_d", "nu_d")}
# The bounds one fp32 chain is held to another over the same K steps (the
# port against JAX on the CPU, tests/test_torch_protocol_parity.py, whose
# docstring gives the fp64 arbiter's readings behind them; the kernel path
# against the plain scan and against the CPU path on the card, phase 15):
# per loss term the largest relative difference over the steps; per vector
# the relative L2 distance, and for the finetune's updates the ratio of the
# two norms within CHAIN_NORM_RATIO of 1. G's finetune moments are held in
# fp64 alone (tests/test_torch_protocol_parity_fp64.py): in fp32 JAX's own
# chain lies 0.60 / 0.63 from the fp64 one there, and a bound of 1 or more
# would pass a vector of zeros.
CHAIN_LOSS_RTOL = {"pre": dict.fromkeys(PRE_LOSS_KEYS, 1e-3),
                   "ft": {"loss": 1e-2, "dice": 1e-2, "m_dice": 1e-2, "recon": 1e-2,
                          "kld": 1e-2, "g_gan": 0.1, "loss_d": 0.1}}
CHAIN_VECTOR_REL_L2 = {"pre": {"delta_g": 0.1, "mu_g": 0.1, "nu_g": 0.1, "bn": 0.0},
                       "ft": {"delta_g": 0.6, "bn": 3e-2, "delta_d": 0.4, "mu_d": 0.3,
                              "nu_d": 0.2}}
CHAIN_NORM_RATIO = 0.1
CHAIN_EVAL_RTOL = 0.1


def chain_batches(crop, seed: int = CHAIN_BATCH_SEED):
    """The chain's inputs, NCDHW float32 numpy: one (x, mask) per pretrain
    step, per finetune step and for the closing evaluation, from one
    RandomState."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(CHAIN_K_PRE + CHAIN_K_FT + 1):
        x = rng.rand(1, 4, *crop).astype(np.float32)
        mask = (rng.rand(1, 3, *crop) > 0.7).astype(np.float32)
        out.append((x, mask))
    return out


def chain_weights(ref=None) -> dict:
    """JAX's draws of the chain's weights from CHAIN_REF as the port's state
    dicts: "pre" (the pretrain net), "flag" (the flagship) and "disc"."""
    import numpy as np
    from chip_smoke import npz_tree
    from xlstm_hved_torch.utils.convert import params_from_jax

    ref = np.load(CHAIN_REF) if ref is None else ref
    out = {}
    for name in ("pre", "flag", "disc"):
        tree = npz_tree(ref, name)
        out[name] = params_from_jax(tree["params"], tree.get("batch_stats"))
    return out


@contextlib.contextmanager
def pinned_draws(subsets):
    """Inside, the port's train and pretrain steps take their subsets from
    `subsets` in order, and the latents are the means (no noise): the draws
    that differ between the packages only by their RNG streams."""
    from xlstm_hved_torch.engine import train as ttrain
    from xlstm_hved_torch.models import hved

    order = iter(subsets)
    saved = ttrain.sample_subset_index, hved.reparametrize
    ttrain.sample_subset_index = lambda generator, lo=1, hi=3: next(order)
    hved.reparametrize = lambda mu, logvar, deterministic=False, generator=None: mu
    try:
        yield
    finally:
        ttrain.sample_subset_index, hved.reparametrize = saved
    if next(order, None) is not None:
        raise RuntimeError("pinned_draws: fewer steps than pinned subsets")


def _snapshot(module) -> dict:
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _bn_stats(module) -> dict:
    return {n: b.detach().clone() for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _numpy(tensors: dict) -> dict:
    """{name: numpy array}, fp32 (fp64 from an fp64 run)."""
    import torch

    return {n: t.detach().to("cpu", torch.float64 if t.dtype == torch.float64
                             else torch.float32).numpy() for n, t in tensors.items()}


def _adam_moments(module, opt):
    mu = {n: opt.state[p]["exp_avg"] for n, p in module.named_parameters()}
    nu = {n: opt.state[p]["exp_avg_sq"] for n, p in module.named_parameters()}
    return _numpy(mu), _numpy(nu)


def run_chain(dev, weights: dict, batches, compute_dtype: str = "float32",
              disc_dtype: str = "float32", mlstm_kernel=None, fp64: bool = False) -> dict:
    """The protocol's chain through the port's own builders, as the CLIs
    run it: the pretrain net (CHAIN_MODEL, shared_recon=False) with
    create_train_state, JAX's weights loaded, make_pretrain_step with the
    seg decoders frozen, CHAIN_K_PRE steps; the flagship and D built the
    same way, surgical_restore from the pretrained net, make_train_step,
    CHAIN_K_FT steps; then make_eval_step with the instance-missing drop
    CHAIN_EVAL_DROP. The subsets and latents are pinned (`pinned_draws`).
    `mlstm_kernel` is HVEDConfig's (None: the kernels on a card, the plain
    scan on the CPU; False: the plain scan). `fp64` runs all of it in
    float64 (with compute_dtype "float32", which casts nothing): the
    arbiter of fp32 differences.
    Returns per phase the per-step losses and kernel launches and plain-scan
    calls (`utils/phase_report.py`'s counts) and, as numpy by parameter name,
    the update of every parameter, Adam's moments and the BatchNorm
    statistics' movement; the surgery's names and the evaluation."""
    import numpy as np
    import torch
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine import train as ttrain
    from xlstm_hved_torch.engine.checkpoint import surgical_restore
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.nn.blocks import compute_dtype as as_dtype
    from xlstm_hved_torch.utils.phase_report import launch_counts

    crop = tuple(batches[0][0].shape[2:])
    cfg = TrainConfig(crop_size=crop, num_epochs=CHAIN_EPOCHS)
    dtype = torch.float64 if fp64 else torch.float32
    to = lambda a: torch.from_numpy(a).to(dev, dtype)
    sample = torch.zeros((1, 4, *crop), device=dev, dtype=dtype)

    def net(**kw):
        return find_model_using_name(CHAIN_MODEL, device=dev, compute_dtype=compute_dtype,
                                     mlstm_kernel=mlstm_kernel, **kw).to(dtype)

    def disc():
        return Discriminator(f_maps=CHAIN_DISC[0], kernel=CHAIN_DISC[1],
                             dtype=as_dtype(disc_dtype)).to(dtype)

    record = {}
    pre = net(shared_recon=False)
    state = ttrain.create_train_state(pre, disc(), cfg, 0, sample, CHAIN_STEPS_PER_EPOCH)
    pre.load_state_dict(weights["pre"], strict=True)
    theta0, bn0 = _snapshot(pre), _bn_stats(pre)
    step = ttrain.make_pretrain_step(pre, cfg, CHAIN_STEPS_PER_EPOCH,
                                     freeze_mask=ttrain.freeze_mask_for(pre, ("sdecoder",)))
    losses, launches = [], []
    with pinned_draws(CHAIN_PRE_SUBSETS):
        for x, _mask in batches[:CHAIN_K_PRE]:
            before = launch_counts()
            state, metrics = step(state, to(x))
            losses.append([float(metrics[k]) for k in PRE_LOSS_KEYS])
            launches.append({k: v - before[k] for k, v in launch_counts().items()})
    mu, nu = _adam_moments(pre, state.opt_g)
    record["pre"] = dict(
        losses=np.array(losses), launches=launches, mu_g=mu, nu_g=nu,
        delta_g=_numpy({n: p - theta0[n] for n, p in pre.named_parameters()}),
        bn=_numpy({n: b - bn0[n] for n, b in _bn_stats(pre).items()}))

    flag = net()
    d = disc()
    state = ttrain.create_train_state(flag, d, cfg, 0, sample, CHAIN_STEPS_PER_EPOCH)
    flag.load_state_dict(weights["flag"], strict=True)
    d.load_state_dict(weights["disc"], strict=True)
    loaded, skipped = surgical_restore(flag, pre.state_dict())
    del pre
    theta0, d0, bn0 = _snapshot(flag), _snapshot(d), _bn_stats(flag)
    step = ttrain.make_train_step(flag, d, cfg, CHAIN_STEPS_PER_EPOCH)
    losses, launches = [], []
    with pinned_draws(CHAIN_FT_SUBSETS):
        for x, mask in batches[CHAIN_K_PRE:CHAIN_K_PRE + CHAIN_K_FT]:
            before = launch_counts()
            state, metrics = step(state, to(x), to(mask))
            losses.append([float(metrics[k]) for k in FT_LOSS_KEYS])
            launches.append({k: v - before[k] for k, v in launch_counts().items()})
    mu_g, nu_g = _adam_moments(flag, state.opt_g)
    mu_d, nu_d = _adam_moments(d, state.opt_d)
    x, mask = (to(a) for a in batches[-1])
    x_missing = x.clone()
    x_missing[:, list(np.flatnonzero(CHAIN_EVAL_DROP))] = 0.0
    metrics = ttrain.make_eval_step(flag)(x, x_missing, mask)
    record["ft"] = dict(
        losses=np.array(losses), launches=launches, mu_g=mu_g, nu_g=nu_g, mu_d=mu_d, nu_d=nu_d,
        delta_g=_numpy({n: p - theta0[n] for n, p in flag.named_parameters()}),
        delta_d=_numpy({n: p - d0[n] for n, p in d.named_parameters()}),
        bn=_numpy({n: b - bn0[n] for n, b in _bn_stats(flag).items()}),
        eval=np.array([float(metrics[k]) for k in CHAIN_EVAL_KEYS]))
    record["surgery"] = (sorted(loaded), sorted(skipped))
    return record


def chain_distances(got: dict, want: dict) -> dict:
    """How far one chain record lies from another: per phase the largest
    relative difference of each loss term over the steps (and the
    per-step worst), and for each compared vector (CHAIN_VECTORS) the
    relative L2 distance of all its tensors at once, the ratio of the two
    norms, and its worst tensor
    (relative L2 over the larger of its own norm and 1e-3 of the largest
    tensor norm); the evaluation's largest relative difference."""
    import numpy as np

    out = {}
    for phase, names in CHAIN_VECTORS.items():
        g, w = got[phase], want[phase]
        rel = np.abs(g["losses"] - w["losses"]) / np.maximum(np.abs(w["losses"]), 1e-12)
        res = {"loss_rel": rel.max(axis=0), "loss_rel_step": rel.max(axis=1)}
        for name in names:
            if name not in w:   # a stored reference that keeps only some vectors
                continue
            if sorted(g[name]) != sorted(w[name]):
                raise ValueError(f"{phase} {name}: the tensors differ by name: "
                                 f"{sorted(set(g[name]) ^ set(w[name]))[:5]}")
            keys = sorted(w[name])
            diff = {k: np.asarray(g[name][k], np.float64) - np.asarray(w[name][k], np.float64)
                    for k in keys}
            norms = {k: float(np.linalg.norm(np.asarray(w[name][k], np.float64))) for k in keys}
            total = math.sqrt(sum(n * n for n in norms.values()))
            dist = math.sqrt(sum(float(np.sum(d * d)) for d in diff.values()))
            floor = 1e-3 * max(norms.values())
            per = {k: float(np.linalg.norm(diff[k])) / max(norms[k], floor, 1e-30)
                   for k in keys}
            worst = max(per, key=per.get)
            got_norm = math.sqrt(sum(float(np.sum(np.asarray(g[name][k], np.float64) ** 2))
                                     for k in keys))
            res[name] = {"rel_l2": dist / total if total > 0 else dist,
                         "norm": total, "norm_ratio": got_norm / total if total > 0 else 1.0,
                         "worst": (worst, per[worst])}
        out[phase] = res
    if "eval" in want["ft"]:   # a JAX chain run without its evaluation step has none
        ge, we = got["ft"]["eval"], want["ft"]["eval"]
        out["eval_rel"] = float(np.max(np.abs(ge - we) / np.maximum(np.abs(we), 1e-12)))
    return out


def chain_faults(dist: dict) -> list:
    """The bounds (CHAIN_*) that `chain_distances` breaks, as lines."""
    faults = []
    for phase, keys in (("pre", PRE_LOSS_KEYS), ("ft", FT_LOSS_KEYS)):
        for key, rel in zip(keys, dist[phase]["loss_rel"]):
            if not rel <= CHAIN_LOSS_RTOL[phase][key]:
                faults.append(f"{phase} {key}: relative difference {rel:.3e} > "
                              f"{CHAIN_LOSS_RTOL[phase][key]}")
        for name, bound in CHAIN_VECTOR_REL_L2[phase].items():
            res = dist[phase].get(name)
            if res is None:
                continue
            if not res["rel_l2"] <= bound:
                faults.append(f"{phase} {name}: relative L2 {res['rel_l2']:.3e} > {bound} "
                              f"(worst {res['worst']})")
            if (phase == "ft" and name.startswith("delta")
                    and not abs(res["norm_ratio"] - 1.0) <= CHAIN_NORM_RATIO):
                faults.append(f"{phase} {name}: norm ratio {res['norm_ratio']:.4f}")
    if not dist.get("eval_rel", 0.0) <= CHAIN_EVAL_RTOL:
        faults.append(f"evaluation: relative difference {dist['eval_rel']:.3e} > "
                      f"{CHAIN_EVAL_RTOL}")
    return faults


def describe_distances(dist: dict) -> list:
    """chain_distances as printable lines."""
    lines = []
    for phase, keys in (("pre", PRE_LOSS_KEYS), ("ft", FT_LOSS_KEYS)):
        res = dist[phase]
        lines.append(f"{phase} losses, largest relative difference over the steps: " + ", ".join(
            f"{k} {v:.2e}" for k, v in zip(keys, res["loss_rel"])) + "; per step " +
            " ".join(f"{v:.2e}" for v in res["loss_rel_step"]))
        for name in CHAIN_VECTORS[phase]:
            if name not in res:
                continue
            r = res[name]
            lines.append(f"{phase} {name}: relative L2 {r['rel_l2']:.3e} (norm {r['norm']:.3e}, "
                         f"ratio {r['norm_ratio']:.4f}), worst tensor {r['worst'][0]} "
                         f"{r['worst'][1]:.3e}")
    if "eval_rel" in dist:
        lines.append(f"evaluation, largest relative difference {dist['eval_rel']:.2e}")
    return lines


