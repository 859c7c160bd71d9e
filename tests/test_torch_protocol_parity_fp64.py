"""PyTorch port: the training protocol's chain held to the JAX package over
K steps in float64, on the CPU.

The chain, its weights, batches and pinned draws are those of
tests/test_torch_protocol_parity.py (tests/_torch_chain.py's CHAIN_* settings
at a 16^3 crop): 6 pretrain steps with the seg decoders frozen, the surgery into
the flagship, 6 G+D steps, one evaluation step, each package through its
own builders. Here both run in float64: the port as `model.double()` (its
"float32" compute dtype casts nothing), JAX under `jax.enable_x64` with its
modules' fp32 casts read as fp64 for the trace alone
(tests/make_torch_protocol_ref.py::jax_chain_fp64).

In fp32 the chain amplifies rounding: Adam's first steps turn a gradient's
rounding into the sign of an update, and the region threshold on D's input
flips voxels, so after 6 G+D steps two fp32 runs of one package lie 0.1 to
0.4 apart (relative L2) in the updates and moments. In fp64 that noise is
about 1e-9 of it, so this file holds every step's loss terms to rtol 1e-6,
the updates, Adam's moments and the BatchNorm statistics' movement to
relative L2 1e-5, and the evaluation to rtol 1e-6: the two packages compute
the same chain, step by step. About 100 s alone on 8 cores, most of it JAX
tracing and compiling its three steps in fp64.
"""
import numpy as np
import pytest
import torch

import _torch_chain as tc
import _torch_port as tp
import make_torch_protocol_ref as ref

S = 16
LOSS_RTOL = 1e-6
VECTOR_REL_L2 = 1e-5
EVAL_RTOL = 1e-6


@pytest.fixture(scope="module")
def chains64():
    npz = np.load(ref.OUT)
    batches = tc.chain_batches((S,) * 3)
    want = ref.jax_chain_fp64(ref.weights_from_npz(npz), batches)
    got = tc.run_chain(torch.device("cpu"), tc.chain_weights(npz), batches, fp64=True)
    dist = tc.chain_distances(got, want)
    print("\nthe port's fp64 chain from JAX's, 16^3:")
    for line in tc.describe_distances(dist):
        print("  " + line)
    return got, want, dist


@pytest.mark.parametrize("phase", ["pre", "ft"])
def test_fp64_chain_losses_match_jax_at_every_step(chains64, phase):
    got, want, dist = chains64
    assert got[phase]["losses"].shape == (6, 3 if phase == "pre" else 7)
    assert float(dist[phase]["loss_rel"].max()) <= LOSS_RTOL, dist[phase]["loss_rel"]


@pytest.mark.parametrize("phase,name", [(p, n) for p, names in tc.CHAIN_VECTORS.items()
                                        for n in names])
def test_fp64_chain_state_matches_jax_after_each_phase(chains64, phase, name):
    got, _, dist = chains64
    assert next(iter(got[phase][name].values())).dtype == np.float64
    res = dist[phase][name]
    if phase == "pre" and name == "bn":   # BatchNorm on its running statistics
        assert res["norm"] == 0.0 and res["rel_l2"] == 0.0
        return
    assert res["norm"] > 0.0 and res["rel_l2"] <= VECTOR_REL_L2, (res["rel_l2"], res["worst"])


def test_fp64_chain_grafts_and_evaluates_as_jax(chains64):
    got, want, dist = chains64
    assert set(got["surgery"][1]) == {tp.torch_param_name(k) for k in want["surgery"][1]}
    assert dist["eval_rel"] <= EVAL_RTOL, dict(zip(tc.CHAIN_EVAL_KEYS, got["ft"]["eval"]))
