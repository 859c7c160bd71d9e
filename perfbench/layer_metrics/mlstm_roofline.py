"""The mLSTM kernels' share of their roofline, in %: the least time of
their calls in the traced window (perfbench/roofline.py, at fp32 peaks)
over the time the device spent in them (the union of their launches'
intervals).

A forward call of the narrow kernels (head width up to 16) is three
launches (names containing those below) ending in `mlstm_readout_kernel`, a backward call three ending in
`mlstm_bwd_cols_kernel`; each backward pairs with a forward that saves the
chunk states. A call's shape comes from the configuration: the token count
of its ViL site at the traffic's crop, 4 heads of width 2 * dim / 4, the
traffic's batch, chunk `vil_chunk_size`."""
import math

from perfbench.roofline import bound_ms, mlstm_bwd_cost, mlstm_cost

FORWARD = ("mlstm_chunk_state_kernel", "mlstm_fwd_scan_kernel", "mlstm_readout_kernel")
BACKWARD = ("mlstm_bwd_rows_kernel", "mlstm_bwd_scan_kernel", "mlstm_bwd_cols_kernel")
HEADS = 4


def sites(model: dict, crop):
    """(tokens, head width) of each ViL the configuration runs."""
    f, levels = model["f_maps"], model["num_levels"]
    out = []
    if model.get("mid_vil"):
        dim = f * 2 ** (levels - 1)
        out.append((math.prod(c // 2 ** (levels - 1) for c in crop), 2 * dim // HEADS))
    if model.get("vil_decoder"):
        dim = f * 2 ** (levels - 2)
        out.append((math.prod(c // 2 ** (levels - 2) for c in crop), 2 * dim // HEADS))
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    names = [k[0] for k in ctx.trace.kernels]
    n_fwd = sum("mlstm_readout_kernel" in n for n in names)
    n_bwd = min(sum("mlstm_bwd_cols_kernel" in n for n in names), n_fwd)
    where = sites(ctx.config["model"], ctx.traffic["crop"])
    if not n_fwd or not where:
        return None
    BH = ctx.traffic.get("batch", 1) * HEADS
    L = ctx.config["model"]["vil_chunk_size"]
    fwd = sum(bound_ms(*mlstm_cost(BH, S, DH, L))[0] for S, DH in where) / len(where)
    fwd_states = sum(bound_ms(*mlstm_cost(BH, S, DH, L, True))[0] for S, DH in where) / len(where)
    bwd = sum(bound_ms(*mlstm_bwd_cost(BH, S, DH, L))[0] for S, DH in where) / len(where)
    least_ms = (n_fwd - n_bwd) * fwd + n_bwd * (fwd_states + bwd)
    spent_s = ctx.trace.busy_s(FORWARD + BACKWARD)
    return 100.0 * least_ms * 1e-3 / spent_s if spent_s else None
