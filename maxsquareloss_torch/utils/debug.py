"""Debug and observability switches of the port (counterpart of
``maxsquareloss_tpu/utils/debug.py``).

- ``--debug_nans``: ``anomaly_mode`` runs a train step in autograd's anomaly
  mode (a backward that makes a NaN raises, naming the forward op); the
  step also raises ``FloatingPointError`` on a loss that is not finite
  (``train/steps.py``), as ``jax_debug_nans`` stops a run at its first NaN.
- ``--profile``: ``StepProfiler`` captures a ``torch.profiler`` trace (host
  and, on the card, device activity) of iterations 2-5 of the training
  loop, past the first steps' allocations and kernel builds, and writes it
  as a Chrome trace under ``<checkpoint_dir>/profile``, where the JAX
  trainer writes its trace. The trace carries the program's spans (below),
  and ``StepProfiler.stop`` logs one line per span name: its device and
  host ms per traced step, read through ``records``.
- Spans: ``span(name)`` marks a phase of the program (``msl.step``,
  ``msl.forward``, ``msl.loss``, ``msl.backward``, ``msl.block_backward``,
  ``msl.optimizer``, ``msl.tail``) and ``sync(site)`` each call that blocks
  the host on the device (``msl.sync``). With no ``torch.profiler`` session
  active a span is one shared null context. Under one, it is a
  ``record_function`` (the span lies on the profiler's host timeline, on
  the clock of its device activity), two CUDA timing events on the current
  stream once CUDA is initialised, and a record in a ring of the last
  ``RING`` of its name: the enclosing span, the unit (each outermost
  ``msl.step`` opens a new one), the host start and end, the events.
  ``records(name, last)`` gives the newest records with their host and
  device ms; the benchmark's span readers (``portbench/readers/span_*``)
  read them after a traced window.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 4096  # records kept per span name
_NULL = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "parent", "unit", "site", "host_start", "host_end", "start", "end")


class _Spans:
    """The process's span records: a ring per name, the open spans (the
    backward's spans on autograd's thread see the ``msl.backward`` that
    waits on them), the current unit and each name's count of records."""

    def __init__(self):
        self.rings: dict[str, collections.deque] = {}
        self.open: list[_Record] = []
        self.unit = 0
        self.counts: collections.Counter = collections.Counter()


_SPANS = _Spans()


class _Span:
    __slots__ = ("rec", "fn")

    def __init__(self, name: str, site: str | None):
        rec = self.rec = _Record()
        rec.name, rec.site, rec.start = name, site, None

    def __enter__(self):
        rec, spans = self.rec, _SPANS
        if rec.name == "msl.step" and not spans.open:
            spans.unit += 1
        rec.parent = spans.open[-1].name if spans.open else None
        rec.unit = spans.unit
        spans.open.append(rec)
        self.fn = torch.profiler.record_function(rec.name)
        self.fn.__enter__()
        if torch.cuda.is_initialized():
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        rec.host_start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec, spans = self.rec, _SPANS
        if rec.start is not None:
            rec.end.record()
        rec.host_end = time.perf_counter()
        self.fn.__exit__(*exc)
        spans.open.remove(rec)
        ring = spans.rings.get(rec.name)
        if ring is None:
            ring = spans.rings[rec.name] = collections.deque(maxlen=RING)
        ring.append(rec)
        spans.counts[rec.name] += 1
        return False


def span(name: str, site: str | None = None):
    """The span ``name`` around a ``with`` block: the shared null context
    unless a ``torch.profiler`` session is active (the module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, site)


def sync(site: str):
    """The span ``msl.sync`` around a call that blocks the host on the
    device; its records keep ``site``."""
    return span("msl.sync", site)


def records(name: str, last: int) -> list[dict]:
    """The newest ``last`` records of span ``name``, oldest first: name,
    parent, unit, site, ``host_ms`` and ``device_ms`` (stream time between
    the span's two events; None without them). Waits for the events."""
    out = []
    for rec in list(_SPANS.rings.get(name, ()))[-last:] if last > 0 else ():
        device_ms = None
        if rec.start is not None:
            rec.end.synchronize()
            device_ms = rec.start.elapsed_time(rec.end)
        out.append({"name": rec.name, "parent": rec.parent, "unit": rec.unit, "site": rec.site,
                    "host_ms": (rec.host_end - rec.host_start) * 1e3, "device_ms": device_ms})
    return out


def record_counts() -> dict[str, int]:
    """Records made so far, by span name (``RING`` or fewer of each kept)."""
    return dict(_SPANS.counts)


def anomaly_mode(enabled: bool):
    """Autograd's anomaly mode inside the block when ``enabled``."""
    return torch.autograd.detect_anomaly() if enabled else contextlib.nullcontext()


class StepProfiler:
    """A ``torch.profiler`` trace of iterations [``first``, ``last``) of a
    training loop, ``iteration`` counting the steps done:
    ``before_step(iteration)`` starts it at ``first``,
    ``after_step(iteration)`` ends it once ``last`` is reached,
    ``stop(iteration)`` ends it early (a run shorter than ``last``) and logs
    each span's ms a step to ``logger``. Nothing runs unless ``enabled``."""

    def __init__(self, logdir: str, enabled: bool, device: torch.device,
                 first: int = 2, last: int = 6, logger: logging.Logger | None = None):
        self.dir = os.path.join(logdir, "profile")
        self.enabled, self.device = enabled, device
        self.first, self.last = first, last
        self.logger = logger or logging.getLogger("maxsquareloss_torch")
        self._prof = None
        self._started_at = None
        self._counts: dict[str, int] = {}
        self.path: str | None = None  # the last trace written

    def before_step(self, iteration: int) -> None:
        if self.enabled and self._prof is None and iteration == self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._counts = record_counts()
            self._prof.start()
            self._started_at = iteration

    def after_step(self, iteration: int) -> str | None:
        if self._prof is not None and iteration >= self.last:
            return self.stop(iteration)
        return None

    def stop(self, iteration: int) -> str | None:
        """End the trace at ``iteration`` (the device's work included) and
        write it; its path, or None when no trace was running."""
        if self._prof is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(
            self.dir, f"iterations_{self._started_at}-{iteration - 1}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        steps = max(iteration - self._started_at, 1)
        for name, n in sorted(record_counts().items()):
            recs = records(name, n - self._counts.get(name, 0))
            if recs:
                device = [r["device_ms"] for r in recs if r["device_ms"] is not None]
                self.logger.info(
                    f"span {name}: {len(recs) / steps:g} a step, host "
                    f"{sum(r['host_ms'] for r in recs) / steps:.3f} ms a step, device "
                    + (f"{sum(device) / steps:.3f} ms a step" if device else "not measured"))
        return self.path
