"""Share of its roofline that the CSP model gather's forward (ops.csp._csp_model_gather) reaches, in %."""

from portbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "csp._csp_model_gather", "csp_gather")
