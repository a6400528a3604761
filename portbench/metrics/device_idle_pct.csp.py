"""Share of the traced window in which no operation ran on the device, in %."""

from portbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
