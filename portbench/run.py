"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (weights and inputs made on the card
from ``--seed``, the model loaded, every shape of the cell warmed up, a
training cell's first checked steps) counts as ``setup_s``; then the cell's
units run in a closed loop for ``--seconds`` seconds. With ``--trace 1``
the window runs under ``torch.profiler`` for the traffic's
``trace_units`` at most and the line carries the per-layer metrics, the
device's busy seconds and a breakdown; with ``--trace 0`` the end-to-end
metrics. After the window the program's state is freed and its outputs
are compared with the plain reference (``portbench/reference``): each
number compared is printed beside its limit as the last lines of standard
error, and under ``checks``, the line's last key. The last line of standard
output is the result's JSON object.

Exits with code 2 and prints no result without as many CUDA cards as the
cell asks for, and with code 3 if a module of JAX or of the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache in fixed directories of the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from portbench import harness

    chips = harness.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
