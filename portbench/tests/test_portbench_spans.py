"""The system's spans in a hand-built trace: `trace.read_trace` reads the
benchmark's ranges as before when spans are present, and `spans.read_trace`
gives the same numbers and, by hand, each span's count, launches and idle
time, names the idle gaps by the innermost span, and counts a backward
launched from another thread in the span open on the main thread."""

import pytest
from test_portbench_counts import _Ev, _prof

from portbench.lib import spans, trace

P, S = trace.PREFIX, spans.SPAN


def _events():
    """test_portbench_counts' first trace, with spans of the system inside
    and around the benchmark's ranges, and a backward on another thread."""
    return [
        _Ev(P + "window", "CPU", 0, 100),
        _Ev(P + "layer.a", "CPU", 10, 40),
        _Ev(P + "layer.b", "CPU", 20, 30),          # nested in a
        _Ev("aten::mul", "CPU", 12, 13, corr=1),
        _Ev("aten::add", "CPU", 22, 23, corr=2),
        _Ev("aten::sum", "CPU", 50, 51, corr=3),
        _Ev("k1", "CUDA", 15, 35, link=1),          # launched in a
        _Ev("k2", "CUDA", 30, 45, link=2),          # launched in b, overlaps k1
        _Ev("k3", "CUDA", 60, 70, link=3),          # outside any layer
        _Ev(P + "layer.a", "CUDA", 15, 45),         # the range's device mirror
        _Ev("k0", "CUDA", -20, 5, link=99),         # begins before the window
        _Ev("cuLaunchKernel", "CPU", 25, 26, corr=500),  # a library's launch in b
        _Ev("k4", "CUDA", 80, 90, corr=500),        # ...linked to no host op
    ]


def _spans():
    return [
        _Ev(S + "step", "CPU", 11, 39, corr=600),         # in a, around b
        _Ev(S + "step.forward", "CPU", 11, 19, corr=601),  # holds mul
        _Ev(S + "step.update", "CPU", 21, 29, corr=602),   # in b, holds add
        _Ev(S + "step", "CPU", 48, 75, corr=603),          # outside a: sum
        _Ev(S + "step.backward", "CPU", 49, 74, corr=604),
        _Ev("SumBackward0", "CPU", 55, 56, corr=7, thread=9),
        _Ev("k5", "CUDA", 72, 78, link=7),                 # autograd's launch
        _Ev(S + "other", "CPU", 52, 53, corr=605, thread=9),  # not the window's
    ]


def test_read_trace_reads_the_benchmarks_ranges_as_before():
    """The accepted metrics' inputs: no key of trace.read_trace moves when
    the system's spans are in the trace."""
    plain = trace.read_trace(_prof(_events()))
    assert trace.read_trace(_prof(_events() + _spans()[:5])) == plain


def test_widened_read_trace_keeps_every_value_of_the_ranges():
    evs = _events() + _spans()
    old, new = trace.read_trace(_prof(evs)), spans.read_trace(_prof(evs))
    for key in ("window_s", "busy_s", "device_ops", "n_device_events"):
        assert new[key] == old[key], key
    for key in ("per_range_s", "other_thread_s"):
        # a kernel launched in a span outside every range now counts in the
        # span, not in "(outside any range)"
        ranges = {k: v for k, v in old[key].items() if k != spans.OUTSIDE}
        assert {k: new[key][k] for k in ranges} == ranges, key
        assert set(new[key]) - set(old[key]) <= {k for k in new[key]
                                                 if k.startswith(S)}


def test_span_counts_launches_and_idle_by_hand():
    t = spans.read_trace(_prof(_events() + _spans()))
    assert t["range_count"] == {"layer.a": 1, "layer.b": 1, S + "step": 2,
                                S + "step.forward": 1, S + "step.update": 1,
                                S + "step.backward": 1}
    per = t["per_range_s"]
    assert per[S + "step"] == pytest.approx((20 + 15 + 10 + 10 + 6) * 1e-9)
    assert per[S + "step.forward"] == pytest.approx(20e-9)       # k1
    assert per[S + "step.update"] == pytest.approx(25e-9)        # k2, k4
    assert per[S + "step.backward"] == pytest.approx(16e-9)      # k3, k5
    assert per["layer.a"] == pytest.approx(45e-9)
    assert per[spans.OUTSIDE] == pytest.approx(5e-9)             # k0
    assert t["other_thread_s"] == {S + "step": pytest.approx(6e-9),
                                   S + "step.backward": pytest.approx(6e-9)}
    assert t["launches_in"] == {"layer.a": 3, "layer.b": 2, S + "step": 5,
                                S + "step.forward": 1, S + "step.update": 2,
                                S + "step.backward": 2, spans.OUTSIDE: 1}
    # device busy 0..5, 15..45, 60..70, 72..78, 80..90: gaps 5..15, 45..60,
    # 78..80 and 90..100 with the host in no range, 70..72 in the backward
    assert t["idle_in_s"] == {S + "step": pytest.approx(2e-9),
                              S + "step.backward": pytest.approx(2e-9)}
    assert dict(t["idle_gaps"]) == {
        "host outside any layer": pytest.approx((10 + 15 + 2 + 10) * 1e-9),
        S + "step.backward": pytest.approx(2e-9)}


def test_a_gap_is_named_by_the_innermost_span():
    evs = [
        _Ev(P + "window", "CPU", 0, 100),
        _Ev(P + "layer.a", "CPU", 0, 100),
        _Ev(S + "refine", "CPU", 1, 99, corr=10),
        _Ev(S + "step.update", "CPU", 30, 60, corr=11),
        _Ev("aten::mul", "CPU", 2, 3, corr=1),
        _Ev("aten::add", "CPU", 70, 71, corr=2),
        _Ev("k1", "CUDA", 5, 40, link=1),
        _Ev("k2", "CUDA", 75, 100, link=2),
    ]
    t = spans.read_trace(_prof(evs))
    assert t["idle_gaps"][0] == [S + "step.update", pytest.approx(35e-9)]
    assert trace.read_trace(_prof(evs))["idle_gaps"][0] == [
        "layer.a", pytest.approx(35e-9 + 5e-9)]
    assert t["idle_in_s"][S + "refine"] == pytest.approx(35e-9)
    assert t["idle_in_s"]["layer.a"] == pytest.approx(40e-9)


def test_a_backward_from_another_thread_counts_in_the_main_threads_span():
    evs = [
        _Ev(P + "window", "CPU", 0, 100),
        _Ev(S + "csp.step.backward", "CPU", 10, 60, corr=10),
        _Ev("aten::mul", "CPU", 12, 13, corr=1, thread=7),
        _Ev("cudaLaunchKernel", "CPU", 40, 41, corr=2, thread=7),
        _Ev("k1", "CUDA", 15, 25, link=1),
        _Ev("k2", "CUDA", 42, 52, corr=2),
    ]
    t = spans.read_trace(_prof(evs))
    label = S + "csp.step.backward"
    assert t["per_range_s"][label] == pytest.approx(20e-9)
    assert t["other_thread_s"][label] == pytest.approx(20e-9)
    assert t["launches_in"][label] == 2


def test_readings_from_a_synthetic_ctx():
    ctx = {"units": 2, "trace": {
        "per_range_s": {S + "csp.step.forward": 0.4, S + "csp.step.backward": 0.9,
                        S + "insert.scatter": 0.1},
        "range_count": {S + "csp.refine_batch": 2, S + "csp.step": 160},
        "launches_in": {S + "csp.step": 160 * 301},
        "idle_in_s": {S + "csp.refine_batch": 0.2}}}
    got = {k: r(ctx) for k, (_, r) in spans.READINGS.items()}
    assert got == pytest.approx({
        "csp_forward_ms": 200.0, "csp_backward_ms": 450.0,
        "csp_refine_idle_ms": 100.0, "csp_launches_per_step": 301.0,
        "insertion_scatter_ms.csp": 50.0})
    # the parent's trace has no spans: nothing to read, and nothing raises
    empty = {"units": 2, "trace": {"per_range_s": {}}}
    assert {k: r(empty) for k, (_, r) in spans.READINGS.items()} == dict.fromkeys(
        spans.READINGS)
