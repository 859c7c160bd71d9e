"""Report where the training protocol starts in the PyTorch port and in the
JAX package: the flagship's sigmoid seg heads and recon error straight
after the reference init (the CLIs' --init_scheme default), over seeds;
with `--model pretrain`, the pretrain net's (the flagship's config with a
recon decoder per modality, `shared_recon=False`) recon error, as its
first pretrain step sees it: BatchNorm on its running statistics, the seg
branch off.

    JAX_PLATFORMS=cpu python tests/torch_protocol_start_report.py [--seeds 1 2 3 4 5]
        [--model flagship|pretrain]

Both packages draw their own weights with the same distributions (the
seeds do not give the same draws), so the comparison is of spreads: per
seed and package, the mean probability of each region (WT, TC, ET) over a
32^3 centre crop of a synthetic subject and the fractions of voxels past
0.99 and under 0.01 (a head that starts saturated has almost no gradient
through its sigmoid), and the all-modality recon's mean squared error.
fp32, train-mode BatchNorm (the first train step's), deterministic latents.
"""
import argparse
import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from xlstm_hved_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from xlstm_hved_tpu.engine import train as jtrain  # noqa: E402
from xlstm_hved_tpu.models import Discriminator as JaxDiscriminator  # noqa: E402
from xlstm_hved_tpu.models import find_model_using_name as jax_model  # noqa: E402
from xlstm_hved_torch.config import TrainConfig  # noqa: E402
from xlstm_hved_torch.data.synthetic import synthetic_subject  # noqa: E402
from xlstm_hved_torch.data.transforms import host_eval_transform  # noqa: E402
from xlstm_hved_torch.engine.train import create_train_state  # noqa: E402
from xlstm_hved_torch.models import Discriminator, find_model_using_name  # noqa: E402

CROP = (32, 32, 32)


def _stats(seg, recon, x):
    """seg, recon, x: numpy, channels last."""
    row = {}
    for c, region in enumerate(("WT", "TC", "ET")):
        p = seg[..., c]
        row[region] = (float(p.mean()), float((p > 0.99).mean()), float((p < 0.01).mean()))
    row["recon_mse"] = float(((recon - x) ** 2).mean())
    return row


def port_start(seed, x, pretrain=False):
    kw = {"shared_recon": False} if pretrain else {}
    model = find_model_using_name("XLSTM_HVED", device="cpu", seed=seed, **kw)
    disc = Discriminator(f_maps=8, kernel=3)   # D does not reach G's start
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    create_train_state(model, disc, TrainConfig(crop_size=CROP), seed, xt,
                       init_scheme="reference")
    model.train(not pretrain)
    with torch.no_grad():
        out = model(xt, seg=not pretrain, recon=True, deterministic=True)
    last = lambda t: np.moveaxis(t.numpy(), 1, -1)
    if pretrain:
        return {"recon_mse": float(((last(out.recon) - x) ** 2).mean())}
    return _stats(last(out.seg), last(out.recon), x)


def jax_start(seed, x, model, disc, apply, pretrain=False):
    state, _ = jtrain.create_train_state(model, disc, JaxTrainConfig(crop_size=CROP),
                                         jax.random.PRNGKey(seed), jnp.asarray(x),
                                         init_scheme="reference")
    seg, recon = apply(state.params_g, state.batch_stats_g, jnp.asarray(x))
    if pretrain:
        return {"recon_mse": float(((np.asarray(recon) - x) ** 2).mean())}
    return _stats(np.asarray(seg), np.asarray(recon), x)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--model", choices=("flagship", "pretrain"), default="flagship")
    args = ap.parse_args()
    pretrain = args.model == "pretrain"
    img, labels = synthetic_subject(np.random.RandomState(0), (48, 48, 48))
    x, _ = host_eval_transform(np.moveaxis(img, 0, -1), labels, crop=CROP)
    x = x[None].astype(np.float32)   # (1, D, H, W, 4)

    model = jax_model("XLSTM_HVED", compute_dtype="float32", use_pallas_mlstm=False,
                      **({"shared_recon": False} if pretrain else {}))
    disc = JaxDiscriminator(f_maps=8, kernel=3)

    @jax.jit
    def apply(params, batch_stats, x):
        out, _ = model.apply({"params": params, "batch_stats": batch_stats}, x,
                             seg=not pretrain, recon=True, train=not pretrain,
                             deterministic=True, mutable=["batch_stats"])
        return out.seg, out.recon

    print("package seed | recon MSE" if pretrain else
          "package seed | WT mean, >0.99, <0.01 | TC ... | ET ... | recon MSE")
    for name, start in (("port", lambda s: port_start(s, x, pretrain)),
                        ("jax", lambda s: jax_start(s, x, model, disc, apply, pretrain))):
        for seed in args.seeds:
            r = start(seed)
            cells = "" if pretrain else " | ".join("%.3f %.3f %.3f" % r[k]
                                                   for k in ("WT", "TC", "ET")) + " |"
            print(f"{name:4s} {seed} | {cells} {r['recon_mse']:.3f}".replace("|  ", "| "),
                  flush=True)


if __name__ == "__main__":
    main()
