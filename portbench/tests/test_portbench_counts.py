"""The count functions agree with counts made by hand at tiny shapes, and the
trace reduction with a hand-built trace."""

from types import SimpleNamespace

import pytest

from portbench.lib import peaks, registry, trace


def test_csp_gather_count_by_hand():
    S, T, P, G, m = 2, 3, 5, 7, 16
    params = [(S, T), (S, T), (S, T, 2), (S, P, 3), (S, P, 3), (S, T)]
    shapes = [params, (G, 2), (m, m, m // 2 + 1), 8]
    points = S * T * P * G
    nbytes = (points * 8 + m * m * (m // 2 + 1) * 8 + G * 2 * 4
              + 4 * (3 * S * T + S * T * 2 + 2 * S * P * 3))
    want = max(48 * points / 67e12, nbytes / 3.35e12)
    assert registry.counts("csp_gather").least_seconds(shapes) == pytest.approx(want)
    assert peaks.least_seconds([], 3.35e12) == pytest.approx(1.0)


class _Ev:
    def __init__(self, name, dev, s, e, corr=0, link=0, thread=1):
        self._n, self._d, self._s, self._e = name, dev, s, e
        self._c, self._l, self._t = corr, link, thread

    def name(self):
        return self._n

    def device_type(self):
        return SimpleNamespace(name=self._d)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


def _prof(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def test_trace_reduction_by_hand():
    P = trace.PREFIX
    evs = [
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
    t = trace.read_trace(_prof(evs))
    assert t["window_s"] == pytest.approx(100e-9)
    assert t["busy_s"] == pytest.approx((5 + 30 + 10 + 10) * 1e-9)   # union
    per = t["per_range_s"]
    assert per["layer.a"] == pytest.approx(45e-9)               # b nests in a
    assert per["layer.b"] == pytest.approx(25e-9)
    assert per["(outside any range)"] == pytest.approx(15e-9)
    # gaps 5..15, 45..60, 70..80 and 90..100, named by the host at their start
    assert t["idle_gaps"] == [["host outside any layer", pytest.approx(45e-9)]]
    assert [k for k, _ in t["device_ops"]] == ["k1", "k2", "k3", "k4", "k0"]
    assert t["other_thread_s"] == {}


def test_a_kernel_launched_from_another_thread_counts_in_the_open_range():
    """Autograd launches a CUDA backward from its own thread while the range
    that called it is open on the main thread."""
    P = trace.PREFIX
    evs = [
        _Ev(P + "window", "CPU", 0, 100),
        _Ev(P + "layer.a", "CPU", 10, 60),
        _Ev("aten::mul", "CPU", 12, 13, corr=1),
        _Ev("MulBackward0", "CPU", 40, 41, corr=2, thread=7),
        _Ev("k1", "CUDA", 15, 25, link=1),
        _Ev("k2", "CUDA", 42, 52, link=2),
    ]
    t = trace.read_trace(_prof(evs))
    assert t["per_range_s"]["layer.a"] == pytest.approx(20e-9)
    assert t["other_thread_s"]["layer.a"] == pytest.approx(10e-9)


def test_busy_seconds_of_a_profile_of_cuda_activity_by_hand():
    evs = [_Ev("k1", "CUDA", 100, 130), _Ev("k2", "CUDA", 120, 150),
           _Ev("k3", "CUDA", 200, 210), _Ev("k4", "CUDA", 205, 206)]
    assert trace.busy_seconds(_prof(evs)) == (pytest.approx(60e-9), 4)
    assert trace.busy_seconds(_prof([])) == (0.0, 0)
