"""Kernel launches in the traced window per unit of work (a step, a
sweep): the profiler's device records less the copies and sets."""


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    kernels = [k for k in ctx.trace.kernels if not k[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / ctx.units if kernels else None
