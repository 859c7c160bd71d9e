"""The yardstick's arithmetic: the card's published peaks and the mLSTM
kernels' least bytes and operations.

The cost functions are a frozen copy of `chip_smoke.py`'s `chunk_rows`,
`mlstm_cost`, `mlstm_bwd_cost` and `bound_ms`, so that a later change to
the program cannot move the bound its kernels are held to.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense rates without sparsity, at the full 700 W
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "float32_flop_per_s": 67e12,          # outside the tensor cores
    "tf32_flop_per_s": 495e12,
    "bfloat16_flop_per_s": 989e12,
    "float8_flop_per_s": 1979e12,
}


def peak_flops(dtype: str) -> float:
    return PEAKS[f"{dtype}_flop_per_s"]


def chunk_rows(S: int, L: int):
    return [L] * (S // L) + ([S % L] if S % L else [])


def mlstm_cost(BH: int, S: int, DH: int, L: int, states: bool = False):
    """(bytes, fp32 operations) of the chunkwise forward at the true S and
    DH: q, k, v, a, s, cm read once, h written once (and with `states` each
    chunk's entry C*, n*, m*); per chunk of r rows the causal r(r+1)/2 pairs
    cost a q.k dot, a decay exp and a weighted v row, plus the q.C* readout
    and the C* / n* update."""
    rows = chunk_rows(S, L)
    nbytes = 4 * (3 * BH * S * DH + 3 * BH * S + BH * S * DH)
    if states:
        nbytes += 4 * BH * len(rows) * (DH * DH + DH + 1)
    ops = sum(r * (r + 1) // 2 * (2 * DH + 4 + 2 * DH)
              + 2 * r * DH * DH + 2 * r * DH
              + 2 * r * DH * DH + 3 * r * DH
              + 12 * r
              for r in rows)
    return nbytes, BH * ops


def mlstm_bwd_cost(BH: int, S: int, DH: int, L: int):
    """(bytes, fp32 operations) of the reverse-chunk backward: q, k, v, the
    output gradient, a, s, cm and the entry states read once; dq, dk, dv,
    ds and dax written once; per chunk the readout recomputed, the pair
    adjoints, the row adjoints, the state-update adjoint and the carry."""
    rows = chunk_rows(S, L)
    nbytes = 4 * (4 * BH * S * DH + 3 * BH * S + BH * len(rows) * (DH * DH + DH + 1)
                  + 3 * BH * S * DH + 2 * BH * S)
    ops = sum(r * (r + 1) // 2 * (4 * DH + 4) + r * (2 * DH * DH + 2 * DH + 12)
              + r * (r + 1) // 2 * (8 * DH + 4)
              + r * (4 * DH * DH + 9 * DH + 10)
              + r * (4 * DH * DH + 6 * DH + 4)
              + 4 * DH * DH
              for r in rows)
    return nbytes, BH * ops


def bound_ms(nbytes: int, flops: int):
    """(least time in ms, what bounds it) at the peak HBM and fp32 rates."""
    t_bytes = 1e3 * nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = 1e3 * flops / PEAKS["float32_flop_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
