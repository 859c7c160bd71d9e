"""The frozen roofline arithmetic against the bounds PERF.md's kernel table
gives (NVIDIA H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s fp32), and the mLSTM
roofline's reader on hand-built traces of either kernel path."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

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


def test_vil_sites_of_the_hved_configurations():
    """The HVED builder's mLSTM calls: (batch x heads, tokens, head width,
    chunk) of the flagship's mid-ViL and of the decoder's ViL at the crop."""
    from perfbench.drivers import program

    crop = {"crop": [128, 192, 128], "batch": 1}
    flagship = json.loads((ROOT / "perfbench/configs/xlstm_hved.json").read_text())["model"]
    decoder = json.loads((ROOT / "perfbench/configs/u_hved_conv_xlstm.json").read_text())["model"]
    assert program.vil_sites(flagship, crop) == [(4, 6144, 16, 128)]
    assert program.vil_sites(decoder, crop) == [(4, 49152, 8, 128)]


NARROW_CALLS = {"fwd": ["mlstm_chunk_state_kernel<8>", "mlstm_fwd_scan_kernel<8>",
                        "mlstm_readout_kernel<8>"],
                "bwd": ["mlstm_bwd_rows_kernel<8>", "mlstm_bwd_scan_kernel<8>",
                        "mlstm_bwd_cols_kernel<8>"]}
WIDE_CALLS = {"fwd": ["wide_outer_kernel<0>", "wide_fwd_scan_kernel", "wide_readout_kernel<64>"],
              "bwd": ["wide_bwd_gnum_kernel<64>", "wide_bwd_rows_kernel<64>",
                      "wide_outer_kernel<1>", "wide_bwd_scan_kernel", "wide_bwd_cols_kernel<64>",
                      "wide_bwd_final_kernel", "wide_bwd_carry_kernel"]}


@pytest.mark.parametrize("paths", [("narrow", "narrow"), ("wide", "wide"), ("narrow", "wide")])
def test_mlstm_roofline_counts_calls_of_either_path(paths):
    """Two forward calls and one backward, each launch 1 ms of device apart
    from the others, on the paths given (the first forward and the backward
    on the first): the reader counts the calls by their readout and column
    launches, whatever the path, and divides by the union of both paths'
    launches; other kernels do not count."""
    from types import SimpleNamespace

    from perfbench import harness
    from perfbench.layer_metrics import mlstm_roofline

    calls = {"narrow": NARROW_CALLS, "wide": WIDE_CALLS}
    launched = (calls[paths[0]]["fwd"] + calls[paths[0]]["bwd"] + ["elementwise_kernel"]
                + calls[paths[1]]["fwd"])
    trace = harness.Trace()
    ms = 1_000_000
    trace.kernels = [(f"void (anonymous namespace)::{n}(float const*)", 2 * i * ms,
                      (2 * i + 1) * ms) for i, n in enumerate(launched)]
    config = json.loads((ROOT / "perfbench/configs/u_hved_conv_xlstm.json").read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/sweep.json").read_text())
    ctx = SimpleNamespace(trace=trace, units=1, config=config, traffic=traffic)
    site = (4, 49152, 8, 128)
    least = (bound_ms(*mlstm_cost(*site))[0] + bound_ms(*mlstm_cost(*site, True))[0]
             + bound_ms(*mlstm_bwd_cost(*site))[0])
    spent_ms = len(launched) - 1
    assert mlstm_roofline.read(ctx) == pytest.approx(100.0 * least / spent_ms)
