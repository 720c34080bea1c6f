"""The trace reader on a made-up trace: the busy union, a span's device
time, and the idle gaps by what the host was doing."""

import pytest
from torch.autograd import DeviceType

from portbench.devtrace import Timeline, Trace

US = 1000


class Ev:
    def __init__(self, name, start, end, corr=0, linked=0, device=False,
                 annotation=False):
        self._n, self._s, self._e = name, start * US, end * US
        self._c, self._l, self._d, self._a = corr, linked, device, annotation

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return 1

    def is_user_annotation(self):
        return self._a


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()


def _prof():
    return Prof([
        Ev("pb:window", 0, 1000, corr=1, annotation=True),
        Ev("pb:ortho", 100, 300, corr=2, annotation=True),
        Ev("cudaLaunchKernel", 150, 160, corr=70),
        Ev("cgs_kernel", 200, 400, corr=70, device=True),
        Ev("pb:ortho", 200, 400, corr=2, device=True),       # the GPU copy
        Ev("aten::mul", 480, 520, corr=3),
        Ev("cudaLaunchKernel", 500, 505, corr=71),
        Ev("mul_kernel", 600, 650, corr=71, device=True),
        Ev("aten::item", 700, 950, corr=4),
        Ev("copy_kernel", 960, 970, corr=99, linked=4, device=True),
    ])


def _trace():
    return Trace(_prof())


def test_busy_union_and_device_ops():
    line = Timeline(_prof(), 1e-3)
    assert line.busy_s == pytest.approx(260e-6)       # the copy of pb:ortho left out
    assert line.window_s == 1e-3
    assert line.device_ops()[0] == ["cgs_kernel", pytest.approx(200e-6)]
    assert Trace(_prof()).busy_intervals() == [
        (200 * US, 400 * US), (600 * US, 650 * US), (960 * US, 970 * US)]


def test_span_device_time():
    t = _trace()
    assert t.span_device_s("ortho") == pytest.approx(200e-6)
    assert t.span_device_s("filter") is None
    assert t.linked == 1 and t.unlaid == 0


def test_idle_gaps_by_host_activity():
    gaps = dict((k, v) for k, v in _trace().idle_gaps())
    assert gaps["ortho | none"] == pytest.approx(200e-6)
    assert gaps["window | aten::mul"] == pytest.approx(200e-6)
    assert gaps["window | aten::item"] == pytest.approx(310e-6)
    assert gaps["window | none"] == pytest.approx(30e-6)
