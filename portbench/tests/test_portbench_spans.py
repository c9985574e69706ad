"""The span readers (``readers/span_device.py``, ``span_host.py``,
``span_count.py``) on a made-up trace and a ring the program's own spans
filled, their CUDA events stood in for by a clock that ticks 1 ms a
record: only the window's instances are read (the ring's newest, as many as
the window holds), a span the window or the program lacks reads None, and
each reading is per unit."""

import pytest
import torch

from maxsquareloss_torch.utils import debug
from portbench.readers import span_count, span_device, span_host
from portbench.trace import Trace


class _Event:
    """A CUDA event whose time is the count of events recorded before it."""

    ticks = 0

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = _Event.ticks
        _Event.ticks += 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def _fill(monkeypatch, name: str, device_ms: list[int]):
    """One record of ``name`` a reading of ``device_ms``, oldest first."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for ms in device_ms:
            with debug.span(name):
                _Event.ticks += ms - 1  # the end event ticks once more


def _trace(spans: dict[str, tuple[int, int]]) -> Trace:
    """A window of [1000, 2000) us and, per span name, (instances before the
    window, instances inside it)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 1000,
           "dur": 1000}]
    for name, (before, inside) in spans.items():
        ev += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": 900 - 10 * i, "dur": 5,
                "tid": 1} for i in range(before)]
        ev += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": 1100 + 10 * i,
                "dur": 5, "tid": 1} for i in range(inside)]
    return Trace(ev)


@pytest.mark.parametrize("units", [1, 3])
def test_device_reads_the_windows_newest_records_per_unit(monkeypatch, units):
    _fill(monkeypatch, "msl.forward", [2, 3, 5, 7, 11])
    trace = _trace({"msl.step": (1, units), "msl.forward": (2, 3)})
    got = span_device.read(trace, {"units": units}, {"span": "msl.forward"}, {})
    assert got == pytest.approx((5 + 7 + 11) / units)


def test_host_reads_the_windows_newest_records(monkeypatch):
    _fill(monkeypatch, "msl.tail", [1, 1, 1, 1])
    want = sum(r["host_ms"] for r in debug.records("msl.tail", 2))
    trace = _trace({"msl.step": (0, 2), "msl.tail": (1, 2)})
    assert span_host.read(trace, {"units": 2}, {"span": "msl.tail"}, {}) == pytest.approx(want / 2)


def test_count_per_unit():
    trace = _trace({"msl.step": (1, 4), "msl.sync": (3, 6)})
    assert span_count.read(trace, {"units": 4}, {"span": "msl.sync"}, {}) == 1.5
    # spans in the program but none of this name in the window: no read-back
    assert span_count.read(trace, {"units": 4}, {"span": "msl.other"}, {}) == 0.0


def test_missing_span_reads_none(monkeypatch):
    _fill(monkeypatch, "msl.loss", [4, 4])
    ctx = {"units": 2}
    # the window lacks the span (a parent without spans: no msl.step either)
    assert span_device.read(_trace({"msl.step": (0, 2)}), ctx, {"span": "msl.missing"}, {}) is None
    assert span_host.read(_trace({"msl.step": (0, 2)}), ctx, {"span": "msl.missing"}, {}) is None
    assert span_count.read(_trace({"msl.sync": (0, 2)}), ctx, {"span": "msl.sync"}, {}) is None
    # more instances in the window than the program kept records of
    many = _trace({"msl.step": (0, 2), "msl.loss": (0, debug.RING + 1)})
    assert span_device.read(many, ctx, {"span": "msl.loss"}, {}) is None
    # records without device events (a CPU run) give no device time
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with debug.span("msl.cpu_only"):
            pass
    cpu = _trace({"msl.step": (0, 1), "msl.cpu_only": (0, 1)})
    assert span_device.read(cpu, {"units": 1}, {"span": "msl.cpu_only"}, {}) is None
    assert span_host.read(cpu, {"units": 1}, {"span": "msl.cpu_only"}, {}) > 0
