"""Readings for the limits of the output check, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control_seeds 7,8,9 [--fault_seeds 4,5,6] [--out <file.jsonl>]

For each of ``--seeds`` the program runs as a timed run sets it up, without
the window (training: its checked steps; evaluation and serving: as many
units as the check samples) and is compared with the reference: the lower
readings. For each of ``--control_seeds`` the control runs in the
program's place: for training the reference one precision below the
cell's (``reference/lowp.py``), and the reference over half of each batch
(a planted fault); for evaluation and serving the program's own int8 path.
``--fault_seeds``: the planted fault that a driver module names as its
``FAULT`` (``ddp_train``: each rank on its own gradient). A training
kind's driver is the ``train`` driver or built on it. Each reading is one
JSON line on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, harness  # noqa: E402
from portbench.drivers import train  # noqa: E402


def readings(name: str, seed: int, kind: str, device="cuda", patch=None) -> dict:
    """One seed's numbers: ``kind`` is "program", "control" or "fault"."""
    cell = harness.load_cell(name, patch)
    harness.set_precision(cell.config)
    mod = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    device = torch.device(device)
    t0 = time.perf_counter()
    out = {"workload": name, "seed": seed, "kind": kind}
    if kind == "fault":
        out[mod.FAULT] = mod.Driver(cell, seed, device, fault=mod.FAULT).measure()
    elif issubclass(mod.Driver, train.Driver):
        d = mod.Driver(cell, seed, device)
        if kind == "program":
            out["checks"] = d.measure()
        else:
            d.release_program()
            ref = d.reference()
            out["control"] = compare.train_gaps(d.reference(lower=True), ref)
            out["half_batch"] = compare.train_gaps(d.reference(half=True), ref)
    else:
        d = mod.Driver(cell, seed, device, int8=kind == "control")
        harness.run_window(d, 1e9, max_units=cell.traffic["sample"])
        out["checks" if kind == "program" else "control"] = d.measure()
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--fault_seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    runs = [(int(s), "program") for s in args.seeds.split(",") if s]
    runs += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    runs += [(int(s), "fault") for s in args.fault_seeds.split(",") if s]
    for seed, kind in runs:
        line = json.dumps(readings(args.workload, seed, kind))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        harness.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
