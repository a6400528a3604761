"""What the per-layer metric readers share. A reader gets the run's context:

    ctx["trace"]    read_trace's numbers (per_range_s) of the attribution window
    ctx["busy"]     busy_s and window_s of the busy window (CUDA activity only)
    ctx["calls"]    argument shapes of every call into each range's layer
    ctx["units"]    units completed in the traced window
    ctx["peak_window_bytes"]  device memory peak over the window

and returns a number, or None where the run gave it nothing to read."""

from portbench.lib import registry


def range_ms(ctx, *labels):
    """Device ms a unit launched inside the ranges `labels`, or None where
    none of them ran."""
    per = ctx["trace"]["per_range_s"]
    if not any(label in per for label in labels) or not ctx["units"]:
        return None
    return 1e3 * sum(per.get(label, 0.0) for label in labels) / ctx["units"]


def roofline_pct(ctx, label, kernel):
    """The least time of every call into `label` (counts/<kernel>.py) over
    the device time launched inside it, in %."""
    calls = ctx["calls"].get(label)
    spent = ctx["trace"]["per_range_s"].get(label)
    if not calls or not spent:
        return None
    least = sum(registry.counts(kernel).least_seconds(c) for c in calls)
    return 100.0 * least / spent


def idle_pct(ctx):
    t = ctx["busy"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_gib(ctx):
    return ctx["peak_window_bytes"] / 2**30
