"""The whole unit's share of the card's peak, in %: the operations of one
unit of work as counted over the plain reference (torch's FlopCounterMode:
its matrix products and convolutions, forward and backward where the unit
trains) times the units in the traced window, over the window and the
peak of the configuration's compute dtype (perfbench/roofline.py)."""
from perfbench.roofline import peak_flops


def read(ctx):
    if ctx.trace is None or not ctx.flops_per_unit or not ctx.units:
        return None
    rate = ctx.flops_per_unit * ctx.units / ctx.trace.window_s
    return 100.0 * rate / peak_flops(ctx.config["model"]["compute_dtype"])
