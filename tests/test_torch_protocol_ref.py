"""PyTorch port: tests/torch_protocol_ref.npz, the reference of the training
chain's checks (tests/test_torch_protocol_parity*.py on the CPU,
chip_smoke.py's phase 15 on the card, which has no JAX), against what its
generator tests/make_torch_protocol_ref.py makes today: the weights bit for
bit JAX's create_train_state draws, and the stored settings (crop, steps,
pinned subsets and drop, D) and batch checksum those of
tests/_torch_chain.py. A change to either side that leaves the reference
stale fails here; regenerate it with `python tests/make_torch_protocol_ref.py`.
The stored CPU arbiter of phase 15's bf16 arm, the port's bf16 chain from
its fp32 chain, keeps every loss term within twice JAX's own bf16 distance.
"""
import numpy as np
import pytest

import _torch_chain as tc
import chip_smoke as cs
import make_torch_protocol_ref as ref
from xlstm_hved_torch.models import Discriminator, find_model_using_name


@pytest.fixture(scope="module")
def stored():
    return np.load(ref.OUT)


def test_reference_weights_are_todays_jax_draws(stored):
    arrays = ref.weight_arrays(ref.draw_weights())
    keys = {k for k in stored.files if k.split(".", 1)[0] in ("pre", "flag", "disc")}
    assert keys == set(arrays)
    assert all(np.array_equal(stored[k], arrays[k]) for k in keys)
    # and they load strictly into the port's nets
    weights = tc.chain_weights(stored)
    find_model_using_name(tc.CHAIN_MODEL, device="cpu", shared_recon=False).load_state_dict(
        weights["pre"], strict=True)
    find_model_using_name(tc.CHAIN_MODEL, device="cpu").load_state_dict(weights["flag"],
                                                                        strict=True)
    Discriminator(f_maps=tc.CHAIN_DISC[0], kernel=tc.CHAIN_DISC[1]).load_state_dict(
        weights["disc"], strict=True)


def test_reference_settings_are_the_chains(stored):
    want = ref.settings_arrays()
    for key, value in want.items():
        np.testing.assert_array_equal(stored[key], value, err_msg=key)
    runs = {k.split(".")[0] for k in stored.files if k.endswith(".losses")}
    assert runs == {"jax32", "jax16", "cpu32", "cpu16"}
    assert stored["cpu32.ft.losses"].shape == (tc.CHAIN_K_FT, len(tc.FT_LOSS_KEYS))


@pytest.mark.parametrize("phase", ["pre", "ft"])
def test_port_bf16_chain_keeps_jax_bf16_distance(stored, phase):
    port, jax = stored[f"cpubf16.{phase}.loss_rel"], stored[f"jaxbf16.{phase}.loss_rel"]
    assert np.all(port <= cs.PRECISION_FACTOR * jax), (port, jax)
