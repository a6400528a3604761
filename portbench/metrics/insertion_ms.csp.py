"""Device ms per unit in the CSP insertion (ops.reconstruct.accumulate_matrices)."""

from portbench.lib.readers import range_ms


def read(ctx):
    return range_ms(ctx, "reconstruct.accumulate_matrices")
