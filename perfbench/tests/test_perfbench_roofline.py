"""The frozen roofline arithmetic against the bounds PERF.md's kernel table
gives (NVIDIA H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s fp32)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.roofline import bound_ms, mlstm_bwd_cost, mlstm_cost  # noqa: E402


@pytest.mark.parametrize("cost, args, ms, what", [
    (mlstm_cost, (4, 4096, 16, 128), 0.00135, "operations"),
    (mlstm_bwd_cost, (4, 4096, 16, 128), 0.00386, "operations"),
    (mlstm_cost, (4, 32768, 8, 128), 0.00548, "bytes"),
    (mlstm_cost, (4, 49152, 8, 128), 0.00822, "bytes"),
    (mlstm_bwd_cost, (4, 49152, 8, 128), 0.0220, "operations"),
    (mlstm_cost, (8, 4096, 128, 128), 0.04865, "operations"),
])
def test_bounds_of_the_kernel_table(cost, args, ms, what):
    got, bound_by = bound_ms(*cost(*args))
    assert got == pytest.approx(ms, rel=5e-3)
    assert bound_by == what


def test_states_add_bytes_only():
    plain, states = mlstm_cost(4, 4096, 16, 128), mlstm_cost(4, 4096, 16, 128, states=True)
    assert states[1] == plain[1] and states[0] > plain[0]
