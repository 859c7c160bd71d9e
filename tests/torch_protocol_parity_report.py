"""The fp64 arbiter of tests/test_torch_protocol_parity.py: the training
chain (tests/_torch_chain.py's CHAIN_* settings, 16^3, the weights of
tests/torch_protocol_ref.npz) through the port in fp32 and in fp64 and
through the JAX package in fp32 and in fp64 (`jax.enable_x64`, the JAX
modules' fp32 casts read as fp64 for that trace alone, as
tests/test_torch_pretrain.py runs its objective), and the distance of each
fp32 chain from the port's fp64 one, beside the port's from JAX's, and the
two fp64 chains from each other:

    python tests/torch_protocol_parity_report.py

Where the port's fp32 chain lies nearer the fp64 chain than JAX's fp32
chain does, a difference between the port and JAX is fp32 rounding, not a
fault of the port; where the two fp64 chains agree, the two packages
compute the same chain. About 4 minutes on the CPU.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_chain as tc  # noqa: E402
import make_torch_protocol_ref as ref  # noqa: E402


def main():
    npz = np.load(ref.OUT)
    batches = tc.chain_batches((16,) * 3)
    weights = tc.chain_weights(npz)
    port32 = tc.run_chain(torch.device("cpu"), weights, batches)
    port64 = tc.run_chain(torch.device("cpu"), weights, batches, fp64=True)
    jax32 = ref.jax_chain(ref.weights_from_npz(npz), batches)
    jax64 = ref.jax_chain_fp64(ref.weights_from_npz(npz), batches)
    for label, got, want in (("the port's fp32 chain from JAX's fp32 chain", port32, jax32),
                             ("the port's fp32 chain from the port's fp64 chain", port32, port64),
                             ("JAX's fp32 chain from the port's fp64 chain", jax32, port64),
                             ("JAX's fp64 chain from the port's fp64 chain", jax64, port64)):
        print(label)
        for line in tc.describe_distances(tc.chain_distances(got, want)):
            print("  " + line)


if __name__ == "__main__":
    # tests/conftest.py's settings, before any JAX operation
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_default_matmul_precision", "highest")
    main()
