"""On the chip, at each cell's own size: a traced window reads every span
metric of the cell; in a train cell the four phases (forward, loss,
backward, optimizer) cover at least 90 % of the window's time a step, and
the block backward lies inside the backward; every call that
``torch.cuda.set_sync_debug_mode`` finds blocking in a train step runs
inside an ``msl.sync`` span, one span a call, so ``host_syncs.train``
counts them; so does every such call of the port in an eval batch and a
served request (the serve driver's own copies are not the port's).
Readings go to standard output (``-s``)."""

import collections
import importlib
import traceback
import warnings

import pytest
import torch

from maxsquareloss_torch.utils import debug
from portbench import harness
from portbench.tests.small import CELLS

PHASES = ("forward", "loss", "backward", "optimizer")


def _driver(cell: str, seed: int):
    c = harness.load_cell(cell)
    harness.set_precision(c.config)
    kind = importlib.import_module(f"portbench.drivers.{c.traffic['kind']}")
    return c, kind.Driver(c, seed, torch.device("cuda"))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_read(cell):
    c, driver = _driver(cell, 2**33 + 303)
    units, _, trace = harness.traced_window(driver, 30.0, c.traffic["trace_units"])
    got = harness.read_per_layer(c, trace, {**driver.work(), "units": units})
    spans = [m["name"] for m in c.per_layer if m["reader"].startswith("span_")]
    values = {k: v["value"] for k, v in got.items()}
    unit_ms = trace.window_s * 1e3 / units
    print(f"\n{cell}: units {units}, window ms a unit {unit_ms:.3f}, {values}")
    assert spans and all(n in got for n in spans)
    if c.traffic["kind"] == "train":
        phases = sum(values[f"{p}_ms.train"] for p in PHASES)
        print(f"{cell}: the phases cover {100 * phases / unit_ms:.2f} % of the window a step")
        assert phases >= 0.9 * unit_ms
        assert values["block_backward_ms.train"] <= values["backward_ms.train"]


def _where(frames) -> str:
    return " < ".join(f"{f.filename.split('/')[-1]}:{f.lineno}" for f in reversed(frames[-3:]))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_every_blocking_call_is_a_sync_span(cell):
    harness.release()
    _, driver = _driver(cell, 2**33 + 404)
    found = []  # (the innermost msl.sync open, in the port's code?, where)

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "/maxsquareloss_torch/" in f.filename or "/portbench/" in f.filename]
        open_syncs = [r for r in debug._SPANS.open if r.name == "msl.sync"]
        port = bool(frames) and "/maxsquareloss_torch/" in frames[-1].filename
        found.append((open_syncs[-1] if open_syncs else None, port, _where(frames)))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = debug.record_counts().get("msl.sync", 0)
    with torch.profiler.profile(activities=acts), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            driver.unit(0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    made = debug.record_counts().get("msl.sync", 0) - before
    sites = collections.Counter(r["site"] for r in debug.records("msl.sync", made))
    print(f"\n{cell}: msl.sync spans {dict(sites)}; blocking calls:")
    for r, port, where in found:
        print(f"  {r.site if r else None} {'port' if port else 'driver'} {where}")
    assert all(r is not None for r, port, _ in found if port)
    assert len({id(r) for r, _, _ in found if r is not None}) == made
