"""PyTorch port: the training protocol's chain held to the JAX package over
K steps from the same weights, on the CPU, in fp32: every step's loss
terms, and the pretrain's update, Adam moments and BatchNorm statistitc.

The chain (tests/_torch_chain.py): the pretrain net (XLSTM_HVED's config,
`shared_recon=False`) takes CHAIN_K_PRE = 6 pretrain steps with its seg
decoders frozen, is grafted into the flagship by `surgical_restore` (204
tensors loaded, 5 skipped: the heads keep their own draw), and the flagship
and D take CHAIN_K_FT = 6 G+D steps. Both packages run their real builders
(`make_pretrain_step` with `freeze_mask_for(..., ("sdecoder",))`,
`make_train_step`, `surgical_restore`) at two steps an epoch over three
epochs, so the poly learning rate steps down twice in each phase.

Set-up (tests/_torch_chain.py's CHAIN_* settings, tests/make_torch_protocol_ref.py):
- the weights are JAX's `create_train_state(..., init_scheme="reference")`
  draws of the pretrain net, the flagship and Discriminator(f_maps 8,
  kernel 3), read from tests/torch_protocol_ref.npz and carried to the port
  by `params_from_jax` (strict). D is the small one of
  tests/test_torch_train.py: a kernel-4 D needs more than a 16^3 crop;
- fp32 on both sides, JAX at "highest" (tests/conftest.py), a 16^3 crop,
  one numpy-seeded batch per step given to both;
- pinned in this test alone: each step's subset (one fixed list), the
  latents (the means), the instance-missing drop (one fixed mask).

Bounds. The pretrain's loss terms at every step: rtol 1e-3. The rest were
first held to rtol 1e-3 (losses) and relative L2 3e-2 (the vectors) and
broke them; the port's fp64 copy decided: in every loss term and vector
the port's fp32 chain lies nearer the port's fp64 chain than JAX's fp32
chain does, and the two fp64 chains agree to 2e-6
(tests/test_torch_protocol_parity_fp64.py, which holds the finetune's
vectors and the evaluation). They are fp32 rounding, amplified (Adam's
first steps turn a gradient's rounding into the sign of an update; the
region threshold of D's input flips voxels), not a fault, and the bounds
are restated at about twice what JAX's fp32 chain lies from the fp64 one:
- the pretrain's update and moments: relative L2 0.1 (JAX's fp32 from the
  fp64 chain 3.7e-2 to 4.8e-2; the port's fp32 3.3e-3 to 7.8e-3);
- the finetune's loss terms at every step: rtol 1e-2, and 0.1 for the two
  GAN terms (JAX's fp32 from the fp64 chain up to 4.0e-3, and 6.7e-2 /
  4.4e-2 for g_gan / loss_d).
Past the pretrain two fp32 runs of one package lie 0.1 to 0.4 apart in the
vectors, so the finetune's are held in fp64 alone. The per-tensor worst is
printed (`pytest -s`). JAX skips its evaluation step here (its compile).
"""
import numpy as np
import pytest
import torch

import _torch_chain as tc
import _torch_port as tp
import make_torch_protocol_ref as ref

S = 16


@pytest.fixture(scope="module")
def chains():
    """JAX's chain, then the port's, with their distances."""
    npz = np.load(ref.OUT)
    batches = tc.chain_batches((S,) * 3)
    want = ref.jax_chain(ref.weights_from_npz(npz), batches, evaluate=False)
    got = tc.run_chain(torch.device("cpu"), tc.chain_weights(npz), batches)
    dist = tc.chain_distances(got, want)
    print("\nthe port's fp32 chain from JAX's, 16^3:")
    for line in tc.describe_distances(dist):
        print("  " + line)
    return got, want, dist


@pytest.mark.parametrize("phase", ["pre", "ft"])
def test_chain_losses_match_jax_at_every_step(chains, phase):
    got, want, dist = chains
    keys = tc.PRE_LOSS_KEYS if phase == "pre" else tc.FT_LOSS_KEYS
    assert got[phase]["losses"].shape == want[phase]["losses"].shape == (6, len(keys))
    assert np.isfinite(got[phase]["losses"]).all()
    bounds = tc.CHAIN_LOSS_RTOL[phase]
    worst = dict(zip(keys, dist[phase]["loss_rel"]))
    assert all(worst[k] <= bounds[k] for k in keys), worst


@pytest.mark.parametrize("phase,name", [("pre", n) for n in tc.CHAIN_VECTORS["pre"]])
def test_chain_state_matches_jax_after_each_phase(chains, phase, name):
    """The parameters' update, Adam's moments and the BatchNorm statistics'
    movement after the pretrain (the finetune's: the fp64 file); the
    pretrain step keeps BatchNorm on its running statistics, so there both
    packages leave them where they were."""
    _, _, dist = chains
    res = dist[phase][name]
    if name == "bn":
        assert res["norm"] == 0.0 and res["rel_l2"] == 0.0
        return
    assert res["norm"] > 0.0
    assert res["rel_l2"] <= tc.CHAIN_VECTOR_REL_L2[phase][name], (res["rel_l2"], res["worst"])


def test_chain_freezes_and_grafts_as_jax(chains):
    got, want, _ = chains
    loaded, skipped = got["surgery"]
    assert set(loaded) == {tp.torch_param_name(k) for k in want["surgery"][0]}
    assert set(skipped) == {tp.torch_param_name(k) for k in want["surgery"][1]}
    assert (len(loaded), len(skipped)) == (204, 5)
    # the frozen seg decoders stay where they were in both packages
    frozen = [n for n in got["pre"]["delta_g"] if "sdecoder" in n]
    assert frozen and all(not got["pre"]["delta_g"][n].any() for n in frozen)
    assert all(not want["pre"]["delta_g"][n].any() for n in frozen)
