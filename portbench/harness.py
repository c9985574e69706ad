"""The benchmark's general parts: the cell's files, inputs made from the
seed, the measured window, the trace's per-layer metrics, the
check and the result line.

A cell is found by its name in ``BENCHMARK.json``, which names its
configuration (``configs/<config>.json``, whose ``model.backbone`` picks
the architecture's module ``models/<backbone>.py``) and its traffic
(``traffic/<traffic>.json``, whose ``kind`` picks the driver
``drivers/<kind>.py``); the limits of its output check are in
``cells/<cell>.json``; each per-layer metric is ``metrics/<metric>.json``,
read by ``readers/<reader>.py``. A new cell, traffic mix, metric or
architecture is a new file.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import hashlib
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "maxsquareloss_tpu", "bench")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, patch: dict | None) -> dict:
    """``base`` with ``patch``'s keys set, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (patch or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    peaks: dict


def _listed(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, patch: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; ``patch``
    ({"config": ..., "traffic": ..., "limits": ..., "chips": ...}) overrides
    their keys and the cards (the tests' small sizes)."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    patch = patch or {}
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [merge(m, _json(HERE / "metrics" / f"{m['name']}.json"))
                 for m in bench["per_layer"] if _listed(m, name, reported)]
    return Cell(
        name=name, chips=int(patch.get("chips", w["chips"])),
        config=merge(_json(root / configs[w["config"]]["file"]), patch.get("config")),
        traffic=merge(_json(HERE / "traffic" / f"{w['traffic']}.json"), patch.get("traffic")),
        limits=merge(_json(HERE / "cells" / f"{name}.json")["limits"], patch.get("limits")),
        end_to_end=e2e, per_layer=per_layer, peaks=_json(HERE / "peaks.json"),
    )


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


class Phases:
    """Seconds of each named part of the set-up, since the last mark."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = round(now - self.t, 3)
        self.t = now


def make_images(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uint8 RGB images (..., H, W, 3)."""
    return torch.randint(0, 256, (*shape, 3), generator=gen, device=device, dtype=torch.uint8)


def make_labels(gen: torch.Generator, shape, num_classes: int, block: int, ignore: float,
                device) -> torch.Tensor:
    """int32 label maps (..., H, W): a class per ``block`` x ``block`` tile,
    a share ``ignore`` of the tiles -1."""
    *lead, h, w = shape
    th, tw = -(-h // block), -(-w // block)
    cls = torch.randint(0, num_classes, (*lead, th, tw), generator=gen, device=device)
    drop = torch.rand((*lead, th, tw), generator=gen, device=device) < ignore
    cls = torch.where(drop, -1, cls).to(torch.int32)
    return cls.repeat_interleave(block, -2).repeat_interleave(block, -1)[..., :h, :w].contiguous()


def set_precision(config: dict) -> None:
    """TF32 as the configuration states it."""
    tf32 = bool(config["precision"]["tf32"])
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(driver, seconds: float, max_units: int | None = None,
               start: int = 0) -> tuple[int, float]:
    """Units ``start``, ``start + 1``, ... in a closed loop until ``seconds``
    have passed (or ``max_units`` are done), then a wait for the device:
    (units, seconds)."""
    sync(driver.device)
    t0 = time.perf_counter()
    k = 0
    while True:
        driver.unit(start + k)
        k += 1
        if time.perf_counter() - t0 >= seconds or (max_units and k >= max_units):
            break
    driver.finish()
    return k, time.perf_counter() - t0


def traced_window(driver, seconds: float, max_units: int):
    """``run_window`` under ``torch.profiler``, after one unit that warms
    the profiler up outside the window's span; (units, seconds, Trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.trace import WINDOW_SPAN, Trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        run_window(driver, 0.0, 1)
        with record_function(WINDOW_SPAN):
            units, secs = run_window(driver, seconds, max_units, start=1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        trace = Trace.load(path)
    return units, secs, trace


def read_per_layer(cell: Cell, trace, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"portbench.readers.{m['reader']}")
        v = reader.read(trace, ctx, m, cell.peaks)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def memory_peak(driver, device) -> int:
    """The peak of device memory on the fullest card the driver used (one
    card: this process's)."""
    if hasattr(driver, "memory_peak_bytes"):
        return driver.memory_peak_bytes()
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def release() -> None:
    """Collect the program's dropped state and return its memory to the
    device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, patch: dict | None = None) -> dict:
    """Set up, measure and check one run of the cell; the result line's
    object (``checks`` last)."""
    cell = load_cell(name, patch)
    device = torch.device(device or "cuda")
    set_precision(cell.config)
    kind = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    imported = time.perf_counter() - t_start
    driver = kind.Driver(cell, seed, device)
    print(f"portbench: set-up s: imports {imported:.3f} {driver.phases.parts}", file=sys.stderr)
    if trace:
        units, secs, tr = traced_window(driver, seconds, cell.traffic["trace_units"])
    else:
        setup_s = time.perf_counter() - t_start
        units, secs = run_window(driver, seconds)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": memory_peak(driver, device)}
    breakdown = None
    if trace:
        metrics = read_per_layer(cell, tr, {**driver.work(), "units": units})
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
        del tr
    else:
        e2e = driver.e2e(units, secs)
        e2e["setup_s"] = setup_s
        units_of = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units_of[k]} for k, v in e2e.items() if k in units_of}
    attempted, failed = driver.attempted, driver.failed
    numbers = driver.measure()
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    others = {k: v for k, v in numbers.items() if k not in checks}
    print(f"portbench: readings not compared: {others}", file=sys.stderr)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
