"""Reading a ``torch.profiler`` Chrome trace of the measured window.

The window is the host span ``portbench.window`` that the harness records
around the traced units; device operations (kernels, copies, memsets) are
clipped to it. ``busy_s`` is the length of the union of their intervals,
so operations that overlap on several streams count once.
"""

from __future__ import annotations

import json
from collections import defaultdict

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint intervals in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
        w = spans[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = []  # (name, start us, end us), clipped to the window
        self.host = []  # (name, start us, end us, tid)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.device.append((e.get("name", "?"), a, b))
            elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN:
                self.host.append((e.get("name", "?"), a, b, e.get("tid")))
        self.device.sort(key=lambda t: t[1])

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _union(self) -> list[tuple[float, float]]:
        return union((a, b) for _, a, b in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) * 1e-6

    def device_time(self, patterns) -> float:
        """Seconds of the device operations whose name holds one of
        ``patterns`` (summed as they ran: these kernels run one at a time)."""
        return sum(b - a for name, a, b in self.device
                   if any(p in name for p in patterns)) * 1e-6

    def top_ops(self, k: int = 10) -> list[list]:
        by = defaultdict(float)
        for name, a, b in self.device:
            by[name[:120]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda t: -t[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest stretches of the window with nothing on the
        device, each named by the innermost host event under its middle."""
        union = self._union()
        edges = [self.t0] + [x for ab in union for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            under = [h for h in self.host if h[1] <= mid <= h[2]]
            name = min(under, key=lambda h: h[2] - h[1])[0] if under else "host: outside any op"
            out.append([name[:120], (b - a) * 1e-6])
        return out
