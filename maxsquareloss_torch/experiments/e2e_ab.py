"""The bench's ``e2e`` legs (disk → loader → step) of two checkouts on one
card, in turns.

    python -m maxsquareloss_torch.experiments.e2e_ab --parent build/parent

``--parent`` is another checkout of the repo (``git archive <commit> | tar
-x -C build/parent``); the change is the checkout this module lies in. Each
turn is a process in its checkout's root that runs that checkout's ``bench
--mode e2e`` over N_PER_DOMAIN images a domain, EPOCHS timed epochs a leg
and the one dataset under DATA_ROOT, in the turn loop of
``experiments/kernel_ab.py``. A turn of the change that is not counted
writes the dataset, its prepared roots and the warm leg's cache first, and
``os.sync()`` flushes them, so the counted turns read settled files. Then,
for each dtype of ORDERS, its turns in its order: bf16 five a side (the
first reading of this A/B put the change's warm leg 6 % below the
parent's there), fp32 two. A turn's whole output goes to
``<--log_dir>/e2e_ab_<dtype>_<i>.log``.

A turn also reads the card's busy share of each timed epoch: CUDA events
around every step, their summed time over the epoch's wall time (one minus
it is the device's idle share). It wraps the checkout's
``bench_e2e._timed_epoch``, which both checkouts share, so both are read
the same way.

Prints one JSON line a turn (every leg's images/s and busy share, the
checkout's ``hostops`` where it reports it), then one line with each
checkout's mean of each over its turns and the change's ratio to the
parent's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

from maxsquareloss_torch.experiments.bench_e2e import LEG_FIRST_EPOCH
from maxsquareloss_torch.experiments.kernel_ab import MARK, run_turns

CHANGE = Path(__file__).resolve().parents[2]
ABBA = ("parent", "change", "change", "parent")
ORDERS = {"bfloat16": ABBA * 2 + ABBA[:2], "float32": ABBA}
N_PER_DOMAIN = 64
EPOCHS = 3
DATA_ROOT = CHANGE / "build" / "e2e_ab_data"
TURN_SECONDS = 1200.0
TURN = """
import json, time, torch
from maxsquareloss_torch import bench
from maxsquareloss_torch.experiments import bench_e2e

timed_epoch, busy = bench_e2e._timed_epoch, {{}}


def busy_epoch(step, state, src_loader, tgt_loader, epoch, device):
    if device.type != "cuda":
        return timed_epoch(step, state, src_loader, tgt_loader, epoch, device)
    marks = []

    def marked(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step(*a)
        ev[1].record()
        marks.append(ev)
        return out

    t0 = time.perf_counter()
    out = timed_epoch(marked, state, src_loader, tgt_loader, epoch, device)  # synchronized
    wall = time.perf_counter() - t0
    busy[epoch] = sum(a.elapsed_time(b) for a, b in marks) / 1e3 / wall
    return out


bench_e2e._timed_epoch = busy_epoch
result = bench.main({argv!r})
print({mark!r} + json.dumps({{"extra": result["extra"], "busy": busy}}))
"""


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("e2e_ab")
    ap.add_argument("--parent", required=True, help="root of the parent's checkout")
    ap.add_argument("--log_dir", default=str(CHANGE / "build" / "e2e_ab"))
    return ap.parse_args(argv)


def turn_code(dtype: str) -> str:
    argv = ["--mode", "e2e", "--dtype", dtype, "--n_per_domain", str(N_PER_DOMAIN),
            "--epochs", str(EPOCHS), "--data_root", str(DATA_ROOT)]
    return TURN.format(argv=argv, mark=MARK)


def _legs(got: dict) -> dict:
    """A turn's images/s and mean busy share over the timed epochs, by leg."""
    extra, busy = got["extra"], {int(k): v for k, v in got["busy"].items()}
    out = {leg: extra[f"e2e_{leg}_imgs_per_sec"] for leg in LEG_FIRST_EPOCH}
    out["device_only"] = extra["device_only_imgs_per_sec"]
    for leg, first in LEG_FIRST_EPOCH.items():  # the timed epochs follow the priming one
        shares = [busy[e] for e in range(first + 1, first + 1 + EPOCHS) if e in busy]
        out[f"{leg}_busy"] = statistics.mean(shares) if shares else None
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    roots = {"parent": Path(args.parent).resolve(), "change": CHANGE}
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    setup = next(run_turns(roots, ("change",), turn_code(next(iter(ORDERS))), log_dir,
                           "e2e_ab_setup", TURN_SECONDS))
    os.sync()
    print(json.dumps({"setup_seconds": setup[3]}), flush=True)
    summary = {}
    for dtype, order in ORDERS.items():
        turns = {name: [] for name in roots}
        for i, name, got, seconds in run_turns(roots, order, turn_code(dtype), log_dir,
                                               f"e2e_ab_{dtype}", TURN_SECONDS):
            turns[name].append(_legs(got))
            print(json.dumps({"dtype": dtype, "turn": i, "checkout": name, "seconds": seconds,
                              **turns[name][-1], "hostops": got["extra"].get("hostops"),
                              "hostops_calls": got["extra"].get("hostops_calls")}), flush=True)
        means = {name: {k: statistics.mean(t[k] for t in runs) for k in runs[0]
                        if runs[0][k] is not None}
                 for name, runs in turns.items()}
        summary[dtype] = {**means, "change_over_parent": {
            k: means["change"][k] / means["parent"][k] for k in means["change"]}}
    print(json.dumps({"e2e_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
