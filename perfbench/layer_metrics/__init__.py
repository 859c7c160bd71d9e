"""Per-layer readers: `<family>.py` reads every per-layer metric named
`<family>` or `<family>.<cell kind>` with `read(ctx) -> float | None`, from
`ctx.trace` (harness.Trace of the window), `ctx.units` (units of work done
in it), `ctx.config`, `ctx.traffic` and `ctx.flops_per_unit`. None leaves
the metric out of the line."""
