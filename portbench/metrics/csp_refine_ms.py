"""Device ms per unit in the CSP mode schedule (ops.csp.csp_refine_batch), backward included."""

from portbench.lib.readers import range_ms


def read(ctx):
    return range_ms(ctx, "csp.csp_refine_batch")
