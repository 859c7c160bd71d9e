"""The share of the traced window in which no operation ran on the device,
in %: 100 * (1 - busy / window), busy the union of the device operations'
intervals."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
