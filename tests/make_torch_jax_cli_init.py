"""The initial weights the JAX package's CLIs draw for a seed, as the
port's state dicts, for a run of the port from the same start:

    python tests/make_torch_jax_cli_init.py --seed 1 --out runs/jaxinit_seed1.pt

`xlstm_hved_tpu/cli/pretrain.py` and `cli/train.py` at their defaults
(XLSTM_HVED, --init_scheme reference, Discriminator(64, 4), bf16 compute,
remat) draw with `create_train_state(..., split(PRNGKey(seed))[1], ...)`;
this does the same and writes {"pre": the pretrain net, "flag": the
flagship, "disc": the finetune's D} through `params_from_jax`, which
`scripts/torch_protocol_seeds.py --init_from` starts from. The draws do
not depend on the crop.
"""
import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from xlstm_hved_tpu.config import TrainConfig  # noqa: E402
from xlstm_hved_tpu.engine.train import create_train_state  # noqa: E402
from xlstm_hved_tpu.models import Discriminator, find_model_using_name  # noqa: E402
from xlstm_hved_torch.utils.convert import params_from_jax  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    crop = (32, 32, 32)
    cfg = TrainConfig(crop_size=crop)
    sample = jnp.zeros((1, *crop, 4), jnp.float32)
    out = {}
    for name, kw in (("pre", {"shared_recon": False}), ("flag", {})):
        model = find_model_using_name("XLSTM_HVED", compute_dtype="bfloat16", remat=True, **kw)
        disc = Discriminator(f_maps=64, kernel=4, dtype=jnp.bfloat16)
        _, init_rng = jax.random.split(jax.random.PRNGKey(args.seed))
        state, _ = create_train_state(model, disc, cfg, init_rng, sample, 1,
                                      init_scheme="reference")
        state = jax.device_get(state)
        out[name] = params_from_jax(state.params_g, state.batch_stats_g)
        if name == "flag":
            out["disc"] = params_from_jax(state.params_d)
    torch.save(out, args.out)
    weights = lambda sd: [v for n, v in sd.items() if "running" not in n and "num_batches" not in n]
    print(f"wrote {args.out}: " + ", ".join(
        f"{k} sum |w| {sum(float(v.double().abs().sum()) for v in weights(sd)):.6e}"
        for k, sd in out.items()))


if __name__ == "__main__":
    main()
