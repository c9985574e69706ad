"""Every file of the benchmark parses and names only what exists, by the
rules of its contract: each driver kind declares the numbers its cells
compare, each configuration's architecture has its module, and no more
cells than the rule allows take four cards."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _keys(data) -> set[str]:
    """Every key of a configuration file, its nested groups' included."""
    if isinstance(data, dict):
        return set(data).union(*(_keys(v) for v in data.values()))
    if isinstance(data, list):
        return set().union(*(_keys(v) for v in data))
    return set()


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(_one_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/") and _one_line(config["why"])
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["assumed"] and data["precision"]["tf32"] is False
    assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
    assert set(config["reduced"]) <= _keys(data)
    assert (ROOT / "portbench/models" / f"{data['model']['backbone']}.py").is_file()
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and _one_line(cell["why"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((ROOT / "portbench/traffic" / f"{cell['traffic']}.json").read_text())
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    assert hasattr(driver, "Driver")
    assert traffic["dtype"] in ("bfloat16", "float32")
    limits = json.loads((ROOT / "portbench/cells" / f"{cell['name']}.json").read_text())["limits"]
    assert set(limits) == set(driver.CHECKS)
    e2e = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    reported = {m["name"] for m in e2e}
    layer = [m for m in BENCH["per_layer"] if cell["name"] in m["workloads"]]
    assert layer and all(m["moves"] in reported for m in layer)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_four_card_cells():
    cells = BENCH["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    e2e = "bound" in metric
    keys = {"name", "unit", "better", "bound", "source"} if e2e else {
        "name", "unit", "better", "source", "layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace") and 0 < metric["bound"] <= 0.25
        return
    assert _one_line(metric["layer"]) and metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    spec = json.loads((ROOT / "portbench/metrics" / f"{metric['name']}.json").read_text())
    assert hasattr(importlib.import_module(f"portbench.readers.{spec['reader']}"), "read")
    layers = {m["layer"] for m in BENCH["per_layer"] if m["name"].split(".")[0]
              == metric["name"].split(".")[0]}
    assert len(layers) == 1
