"""Report how far the PyTorch port's XLSTM_HVED forward is from the JAX
model on the CPU, per keep-mask, and how far each fp32 forward is from an
fp64 run of the port on the same weights.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

Same weights and input as tests/test_torch_hved.py (1, 4, 32, 32, 32); the
bounds there are set from these numbers.
"""
import copy
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

from _torch_port import max_abs, model_pair, ncdhw, ndhwc  # noqa: E402
from xlstm_hved_tpu.utils.subsets import SUBSET_MASKS  # noqa: E402


def _stacks(out):
    """Expert stacks in the JAX layout (B, 5, D, H, W, C)."""
    return [np.moveaxis(np.asarray(t), 2, -1) for t in (*out.mu, *out.logvar)]


def main():
    tm, fwd, jvars, x = model_pair("XLSTM_HVED")
    rows = []
    for s, keep in enumerate(SUBSET_MASKS):
        with torch.no_grad():
            out = tm(ncdhw(x), keep=torch.tensor(keep), recon=True, deterministic=True)
        ref = fwd(jvars, jnp.asarray(x), jnp.asarray(keep))
        seg_d = np.abs(ndhwc(out.seg) - np.asarray(ref.seg))
        rec_d = np.abs(ndhwc(out.recon) - np.asarray(ref.recon))
        lat = max(max_abs(a, b) for a, b in zip(_stacks(out), (*ref.mu, *ref.logvar)))
        rows.append((seg_d.max(), seg_d.mean(), rec_d.max(), rec_d.mean(), lat))
        print(f"subset {s:2d}: seg max {rows[-1][0]:.3g} mean {rows[-1][1]:.3g} | recon "
              f"max {rows[-1][2]:.3g} mean {rows[-1][3]:.3g} | mu/logvar max {lat:.3g}")
    worst = np.max(np.asarray(rows), axis=0)
    print("worst over 15 masks: seg max %.3g mean %.3g | recon max %.3g mean %.3g | "
          "mu/logvar max %.3g" % tuple(worst))

    keep = torch.tensor(SUBSET_MASKS[14])
    t64 = copy.deepcopy(tm).double()
    with torch.no_grad():
        o64 = t64(ncdhw(x).double(), keep=keep, recon=True, deterministic=True)
        o32 = tm(ncdhw(x), keep=keep, recon=True, deterministic=True)
    ref = fwd(jvars, jnp.asarray(x), jnp.asarray(SUBSET_MASKS[14]))
    for lvl in range(4):
        r = np.moveaxis(o64.mu[lvl].numpy(), 2, -1)
        print(f"level {lvl} mu vs the fp64 port: port fp32 "
              f"{max_abs(np.moveaxis(o32.mu[lvl].numpy(), 2, -1), r):.3g}, "
              f"JAX fp32 {max_abs(ref.mu[lvl], r):.3g}")
    print(f"seg vs the fp64 port: port fp32 {max_abs(o32.seg, o64.seg):.3g}, "
          f"JAX fp32 {max_abs(ref.seg, ndhwc(o64.seg)):.3g}")
    print(f"recon vs the fp64 port: port fp32 {max_abs(o32.recon, o64.recon):.3g}, "
          f"JAX fp32 {max_abs(ref.recon, ndhwc(o64.recon)):.3g}")


if __name__ == "__main__":
    main()
