"""Time the fused bottleneck of two checkouts on one card, in turns.

    python -m maxsquareloss_torch.experiments.kernel_ab --parent build/parent

``--parent`` is another checkout of the repo (``git archive <commit> | tar
-x -C build/parent``); the change is the checkout this module lies in. The
turns run in the order ORDER (parent, change, change, parent), each a
process in its checkout's root that runs that checkout's ``chip_smoke.py``
kernel phases: ``phase_environment``, ``phase_build`` (a
checkout's first turn builds its libraries into its own ``build/``),
``phase_kernels`` (the fp32 eval kernel, timed at a batch-2 1024x512
forward's shapes), ``phase_train_block`` (the fp32 emit kernel, the train
step's shapes) and ``phase_bf16_kernels`` (both bf16 instances at every bf16
path's shape, eval and emit timed). Every check of those phases holds in
every turn. A turn's whole output goes to ``<--log_dir>/kernel_ab_<i>.log``;
a turn may take TURN_SECONDS.

It lives beside the port's other timing experiments, yet imports nothing of
``chip_smoke.py``: each turn is a child process in its own checkout, so the
parent's turns run the parent's phases on the parent's kernels, which one
process could not import beside the change's. ``run_turns`` is that loop
for any turn; ``experiments/e2e_ab.py`` drives the bench's ``e2e`` legs
through it.

Prints one JSON line a turn, then one line with each checkout's mean over its
turns: ms per forward (eval) or per train step (emit) of the four instances,
and ms per shape.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

CHANGE = Path(__file__).resolve().parents[2]
KINDS = ("fp32_eval", "fp32_emit", "bf16_eval", "bf16_emit")
ORDER = ("parent", "change", "change", "parent")
TURN_SECONDS = 900.0
# leads the line of a turn's result; a turn's code holds it as a literal,
# since it runs in the other checkout too
MARK = "AB_RESULT "
TURN = """
import json, chip_smoke as c
c.phase_environment()
c.phase_build()
_, fp32_eval = c.phase_kernels()
_, fp32_emit = c.phase_train_block()
_, (bf16_eval, bf16_emit) = c.phase_bf16_kernels()
entries = dict(zip({kinds!r}, (fp32_eval, fp32_emit, bf16_eval, bf16_emit)))
print({mark!r} + json.dumps({{k: {{"ms": e["ms"], "rows": [
    [r["layer"], r["shape"], r["ms"], r.get("tile", {{}}).get("route", "fma")]
    for r in e["shapes"]]}} for k, e in entries.items()}}))
"""


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("kernel_ab")
    ap.add_argument("--parent", required=True, help="root of the parent's checkout")
    ap.add_argument("--log_dir", default=str(CHANGE / "build" / "kernel_ab"))
    return ap.parse_args(argv)


def run_turn(root: Path, code: str, log: Path, timeout: float) -> dict:
    """``python -c code`` in ``root``, that checkout first on the path: the
    JSON of its last MARK line. Its whole output goes to ``log``."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=timeout)
        f.write(proc.stdout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
    if proc.returncode != 0 or not lines:
        tail = "\n".join(proc.stdout.splitlines()[-20:])
        raise RuntimeError(f"turn in {root} failed ({proc.returncode}); see {log}:\n{tail}")
    return json.loads(lines[-1][len(MARK):])


def run_turns(roots: dict, order, code: str, log_dir: Path, stem: str, timeout: float):
    """The turns of ``order`` (names of ``roots``), each ``run_turn`` of
    ``code`` in its checkout: yields (turn, name, result, seconds)."""
    for i, name in enumerate(order):
        t0 = time.perf_counter()
        got = run_turn(roots[name], code, log_dir / f"{stem}_{i}.log", timeout)
        yield i, name, got, time.perf_counter() - t0


def main(argv=None) -> int:
    args = parse_args(argv)
    roots = {"parent": Path(args.parent).resolve(), "change": CHANGE}
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    turns = {name: [] for name in roots}
    code = TURN.format(kinds=KINDS, mark=MARK)
    for i, name, got, seconds in run_turns(roots, ORDER, code, log_dir, "kernel_ab",
                                           TURN_SECONDS):
        turns[name].append(got)
        print(json.dumps({"turn": i, "checkout": name, "seconds": seconds,
                          **{k: got[k]["ms"] for k in KINDS}}), flush=True)
    summary = {}
    for name, runs in turns.items():
        if not runs:
            continue
        summary[name] = {
            k: {"ms": statistics.mean(r[k]["ms"] for r in runs),
                "turns_ms": [r[k]["ms"] for r in runs],
                "rows": [[layer, shape, statistics.mean(r[k]["rows"][j][2] for r in runs), route]
                         for j, (layer, shape, _, route) in enumerate(runs[0][k]["rows"])]}
            for k in KINDS}
    if len(summary) == 2:
        summary["change_over_parent"] = {
            k: summary["change"][k]["ms"] / summary["parent"][k]["ms"] for k in KINDS}
    print(json.dumps({"kernel_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
