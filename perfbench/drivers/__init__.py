"""The load generators: one module per kind of traffic, each with
`run(cell, seed, seconds, trace, device, t0) -> harness.Window`. A traffic
file names its driver and gives its parameters."""
