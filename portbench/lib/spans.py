"""`read_trace` widened to the system's own spans, and the per-layer
readings they are for.

The system names stretches of its host code `pyp::<name>` in a running
profiler's trace (`pyp_tpu_torch.utils.timer.span`): the CSP refinement,
each mode, a mode's start and keep, each optimizer step and its forward,
backward and update, the final scores, the gather, the insertion and its
scatter. They are host operators on the profiler's clock, with no device
mirror (unlike the `record_function` ranges of `trace.Ranges`).

`read_trace` returns every key of `trace.read_trace`, with the same
values for the benchmark's own ranges and the same device operations, and
  per_range_s, other_thread_s  the spans too, keyed by their full name;
  range_count  instances of each range or span that open in the window;
  launches_in  device operations launched while each was open, counted in
               every one open then, as per_range_s counts their time;
  idle_in_s    idle seconds of the gaps that start while each is open,
               inclusive;
  idle_gaps    named by the innermost range or span of either kind.
Spans count from the host thread that opened the window (a span opened on
another thread would not nest with it); a kernel counts in every span open
when it was launched, on any thread, as in `trace.read_trace`.

`run.py` does not read the spans yet: `span_readings.py` does, on a card.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

from portbench.lib import trace
from portbench.lib.readers import range_ms

SPAN = "pyp::"
OUTSIDE = "(outside any range)"


def read_trace(prof):
    """trace.read_trace's numbers of a finished profile of host and CUDA
    activity, widened to the system's spans (module docstring)."""
    events = list(prof.profiler.kineto_results.events())
    ranges = []            # (start, end, label, host thread)
    spans = []
    launch = {}
    host = {}
    device = []
    for ev in events:
        name = ev.name()
        if ev.device_type().name != "CPU":
            continue
        s, e = trace._t(ev)
        if name.startswith(trace.PREFIX):
            ranges.append((s, e, name[len(trace.PREFIX):], trace._thread(ev)))
            continue
        if name.startswith(SPAN):
            spans.append((s, e, name, trace._thread(ev)))
        if ev.correlation_id() <= 0:
            continue
        if trace._is_runtime_call(name):
            launch.setdefault(ev.correlation_id(), (s, trace._thread(ev)))
        else:
            host.setdefault(ev.correlation_id(), (s, trace._thread(ev)))
    for ev in events:
        name = ev.name()
        if (ev.device_type().name == "CPU" or name.startswith(trace.PREFIX)
                or name.startswith(SPAN)):
            continue
        s, e = trace._t(ev)
        device.append((s, e, name, launch.get(ev.correlation_id(),
                                              host.get(ev.linked_correlation_id()))))
    window = [r for r in ranges if r[2] == trace.WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"expected one {trace.WINDOW!r} range, found {len(window)}")
    w0, w1, _, main = window[0]
    ranges = [r for r in ranges if r[2] != trace.WINDOW]
    ranges += [r for r in spans if r[3] == main]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    # an enclosing range before the ranges it holds, where two open at once
    ranges.sort(key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]

    parent = []
    stack = []
    for i, (s, e, _, _) in enumerate(ranges):
        while stack and ranges[stack[-1]][1] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def open_ranges(t):
        """Labels of every range open at host time t, innermost first."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][1] < t:
            i = parent[i]
        out = []
        while i >= 0:
            out.append(ranges[i][2])
            i = parent[i]
        return out

    per_range = defaultdict(float)
    other_thread = defaultdict(float)
    launches = defaultdict(int)
    per_op = defaultdict(float)
    thread_of = {r[2]: r[3] for r in ranges}
    for s, e, name, t in device:
        dur = (min(e, w1) - max(s, w0)) / 1e9
        per_op[name] += dur
        labels = open_ranges(t[0]) if t is not None else []
        for label in labels or [OUTSIDE]:
            per_range[label] += dur
            launches[label] += 1
            if labels and t[1] != thread_of[label]:
                other_thread[label] += dur
    busy, gaps = trace._union(device, w0, w1)
    idle_by = defaultdict(float)
    idle_in = defaultdict(float)
    for s, e in gaps:
        labels = open_ranges(s)
        idle_by[labels[0] if labels else "host outside any layer"] += (e - s) / 1e9
        for label in labels:
            idle_in[label] += (e - s) / 1e9
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    short = lambda k: k if len(k) <= 160 else k[:157] + "..."  # noqa: E731
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "per_range_s": dict(per_range),
        "other_thread_s": dict(other_thread),
        "device_ops": [[short(k), v] for k, v in top(per_op)],
        "idle_gaps": [[k, v] for k, v in top(idle_by)],
        "n_device_events": len(device),
        "range_count": dict(Counter(r[2] for r in ranges if w0 <= r[0] < w1)),
        "launches_in": dict(launches),
        "idle_in_s": dict(idle_in),
    }


def idle_ms(ctx, label):
    """Idle device ms a unit in gaps that start while `label` is open, or
    None where it never opened."""
    t = ctx["trace"]
    if not t.get("range_count", {}).get(label) or not ctx["units"]:
        return None
    return 1e3 * t["idle_in_s"].get(label, 0.0) / ctx["units"]


def launches_per(ctx, label):
    """Device operations launched inside one instance of `label`, on
    average, or None where it never opened."""
    t = ctx["trace"]
    n = t.get("range_count", {}).get(label)
    if not n:
        return None
    return t["launches_in"].get(label, 0) / n


# The per-layer metrics the spans serve, read from a ctx whose "trace" is
# this read_trace's: name -> (unit, reader).
READINGS = {
    "csp_forward_ms": ("ms", lambda ctx: range_ms(ctx, SPAN + "csp.step.forward")),
    "csp_backward_ms": ("ms", lambda ctx: range_ms(ctx, SPAN + "csp.step.backward")),
    "csp_refine_idle_ms": ("ms", lambda ctx: idle_ms(ctx, SPAN + "csp.refine_batch")),
    "csp_launches_per_step": ("launches",
                              lambda ctx: launches_per(ctx, SPAN + "csp.step")),
    "insertion_scatter_ms.csp": ("ms",
                                 lambda ctx: range_ms(ctx, SPAN + "insert.scatter")),
}
