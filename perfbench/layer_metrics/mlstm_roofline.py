"""The mLSTM kernels' share of their roofline, in %: the least time of
their calls in the traced window (perfbench/roofline.py, at fp32 peaks)
over the time the device spent in them (the union of the intervals of
both paths' launches).

The program runs a call on one of two paths: the narrow kernels (head
width up to 16; names beginning `mlstm_`) or the wide ones (head widths
32 and up; names beginning `wide_`). A forward call of either path makes
one readout launch (`mlstm_readout_kernel`, `wide_readout_kernel`), a
backward call one column launch (`mlstm_bwd_cols_kernel`,
`wide_bwd_cols_kernel`); those count the calls. Each backward pairs with
a forward that saves the chunk states. The calls' shapes come from the
configuration's builder (`vil_sites(model, traffic)`: batch x heads,
tokens, head width and chunk of each ViL's call); a builder without ViLs
has no `vil_sites`, and the metric reads None."""
from perfbench import harness
from perfbench.roofline import bound_ms, mlstm_bwd_cost, mlstm_cost

NARROW = ("mlstm_chunk_state_kernel", "mlstm_fwd_scan_kernel", "mlstm_readout_kernel",
          "mlstm_bwd_rows_kernel", "mlstm_bwd_scan_kernel", "mlstm_bwd_cols_kernel")
WIDE = ("wide_outer_kernel", "wide_fwd_scan_kernel", "wide_readout_kernel",
        "wide_bwd_gnum_kernel", "wide_bwd_rows_kernel", "wide_bwd_scan_kernel",
        "wide_bwd_cols_kernel", "wide_bwd_final_kernel", "wide_bwd_carry_kernel")
KERNELS = NARROW + WIDE
FORWARD_CALL = ("mlstm_readout_kernel", "wide_readout_kernel")
BACKWARD_CALL = ("mlstm_bwd_cols_kernel", "wide_bwd_cols_kernel")


def calls(names, marks) -> int:
    return sum(any(m in n for m in marks) for n in names)


def read(ctx):
    if ctx.trace is None:
        return None
    names = [k[0] for k in ctx.trace.kernels]
    n_fwd = calls(names, FORWARD_CALL)
    n_bwd = min(calls(names, BACKWARD_CALL), n_fwd)
    sites = getattr(harness.builder(ctx.config), "vil_sites", None)
    where = sites(ctx.config["model"], ctx.traffic) if sites else []
    if not n_fwd or not where:
        return None
    fwd = sum(bound_ms(*mlstm_cost(*site))[0] for site in where) / len(where)
    fwd_states = sum(bound_ms(*mlstm_cost(*site, True))[0] for site in where) / len(where)
    bwd = sum(bound_ms(*mlstm_bwd_cost(*site))[0] for site in where) / len(where)
    least_ms = (n_fwd - n_bwd) * fwd + n_bwd * (fwd_states + bwd)
    spent_s = ctx.trace.busy_s(KERNELS)
    return 100.0 * least_ms * 1e-3 / spent_s if spent_s else None
