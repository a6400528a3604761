"""Ranges around the calls into the system's layers, and what a profiler
trace says about them.

`Ranges` replaces module attributes with wrappers that open a
`torch.profiler.record_function` range named `portbench::<label>` around
each call and keep the call's arguments' shapes, so a count function can
work out the operations and bytes from them. Only a traced run installs
them.

Two profiles, two readings:
  `busy_seconds` takes a profile of CUDA activity alone, which records no
  host events and so leaves a host-bound unit nearly as fast as untraced,
  and returns the union of its device intervals (busy time);
  `read_trace` takes a profile of host and CUDA activity and returns the
  device time launched inside each range, nested ranges included, the
  longest idle gaps on the device named by the innermost range the host was
  in, and the device operations that took most time. A kernel belongs to
  every range open when the runtime call that launched it ran, on any host
  thread: autograd launches a CUDA backward from its own device thread,
  outside the tree of the range that called it, so the profiler's own range
  totals leave the backward out.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
from collections import defaultdict

PREFIX = "portbench::"


def _shapes(args):
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            out.append(tuple(int(s) for s in shape))
        elif isinstance(a, (tuple, list)) and a and hasattr(a[0], "shape"):
            out.append([tuple(int(s) for s in x.shape) for x in a])
        else:
            out.append(a if isinstance(a, (int, float, str)) else None)
    return out


class Ranges:
    """Context manager: while open, each (module, attribute, label) in
    `layers` runs inside a profiler range; `calls[label]` holds the
    argument shapes of every call."""

    def __init__(self, layers):
        self.layers = [(importlib.import_module(m), a, label)
                       for m, a, label in layers]
        self.calls = defaultdict(list)
        self._saved = []

    def _wrap(self, fn, label):
        import torch

        calls = self.calls[label]

        def call(*args, **kwargs):
            calls.append(_shapes(args))
            with torch.profiler.record_function(PREFIX + label):
                return fn(*args, **kwargs)
        return call

    def __enter__(self):
        for mod, attr, label in self.layers:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, label))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False


@contextlib.contextmanager
def profiled(host):
    """A torch.profiler profile of CUDA activity, and of host activity too
    where `host`."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _is_runtime_call(name):
    """A CUDA runtime or low-level API call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync...), whose correlation id its device activity carries."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _t(ev):
    """(start, end) in ns of a kinetic event (older releases count in us)."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.start_ns() + ev.duration_ns()
    return ev.start_us() * 1000, (ev.start_us() + ev.duration_us()) * 1000


WINDOW = "window"


def _thread(ev):
    return getattr(ev, "start_thread_id", lambda: 0)()


def _union(intervals, w0, w1):
    """Busy time of (start, end, ...) intervals clipped to [w0, w1], and the
    gaps between them, in the trace's ns."""
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for iv in sorted(intervals, key=lambda iv: iv[0]):
        s, e = max(iv[0], w0), min(iv[1], w1)
        if cur_e is None:
            if s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))
    return busy, gaps


def busy_seconds(prof):
    """(busy s, device events) of a finished profile of CUDA activity: the
    union of every device interval it recorded."""
    device = [_t(ev) for ev in prof.profiler.kineto_results.events()
              if ev.device_type().name != "CPU"]
    if not device:
        return 0.0, 0
    busy, _ = _union(device, min(s for s, _ in device), max(e for _, e in device))
    return busy / 1e9, len(device)


def read_trace(prof):
    """Plain numbers from a finished profile whose measured window ran
    inside a range labelled WINDOW."""
    events = prof.profiler.kineto_results.events()
    ranges = []            # (start, end, label, host thread)
    launch = {}            # CUDA correlation id -> (host start, thread) of the runtime call
    host = {}              # host op correlation id -> (its host start, thread)
    device = []            # (start, end, name, (host start, thread) of its launch or None)
    events = list(events)
    for ev in events:
        name = ev.name()
        if ev.device_type().name != "CPU":
            continue
        s, e = _t(ev)
        if name.startswith(PREFIX):
            ranges.append((s, e, name[len(PREFIX):], _thread(ev)))
        elif ev.correlation_id() <= 0:
            continue
        elif _is_runtime_call(name):
            launch.setdefault(ev.correlation_id(), (s, _thread(ev)))
        else:
            host.setdefault(ev.correlation_id(), (s, _thread(ev)))
    for ev in events:
        name = ev.name()
        if ev.device_type().name == "CPU" or name.startswith(PREFIX):
            continue                           # host events, the ranges' mirrors
        s, e = _t(ev)
        # the launching runtime call, or else the host op it was linked to (a
        # kernel launched from a library outside PyTorch has no host op)
        t = launch.get(ev.correlation_id(), host.get(ev.linked_correlation_id()))
        device.append((s, e, name, t))
    window = [r for r in ranges if r[2] == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"expected one {WINDOW!r} range, found {len(window)}")
    w0, w1 = window[0][:2]
    ranges = [r for r in ranges if r[2] != WINDOW]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    ranges.sort()
    starts = [r[0] for r in ranges]

    # ranges nest on the host thread that opens them: each range's parent
    # is the innermost earlier range still open at its start
    parent = []
    stack = []
    for i, (s, e, _, _) in enumerate(ranges):
        while stack and ranges[stack[-1]][1] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def innermost_index(t):
        """Index of the innermost range open at host time t, or -1."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][1] < t:
            i = parent[i]
        return i

    def innermost(t):
        i = innermost_index(t)
        return None if i < 0 else ranges[i][2]

    def open_ranges(t):
        """Labels of every range open at host time t, innermost first."""
        i = innermost_index(t)
        out = []
        while i >= 0:
            out.append(ranges[i][2])
            i = parent[i]
        return out

    per_range = defaultdict(float)     # inclusive: a nested range counts in its parents too
    other_thread = defaultdict(float)  # of which launched from another host thread
    per_op = defaultdict(float)
    thread_of = {r[2]: r[3] for r in ranges}
    for s, e, name, t in device:
        dur = (min(e, w1) - max(s, w0)) / 1e9
        per_op[name] += dur
        labels = open_ranges(t[0]) if t is not None else []
        for label in labels or ["(outside any range)"]:
            per_range[label] += dur
            if labels and t[1] != thread_of[label]:
                other_thread[label] += dur
    busy, gaps = _union(device, w0, w1)
    idle_by = defaultdict(float)
    for s, e in gaps:
        idle_by[innermost(s) or "host outside any layer"] += (e - s) / 1e9
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
    }
