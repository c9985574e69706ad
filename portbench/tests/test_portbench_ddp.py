"""The ``ddp_train`` kind. On the CPU at the small size with gloo ranks:
two ranks come out correct, their readings within the cell's limits and
the float32 step as close to the reference as one process's, in a traced
run too (every rank under the profiler); the controls
(fp8, half of each share) and the planted fault (each rank steps on its
own gradient under ``no_sync``) fail a limit; a rank killed during the window ends the run with an error, and no
rank is left behind. On four cards at the cell's own size: a program seed
reads within every limit, the controls and the fault fail one."""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.small import small

ROOT = Path(__file__).resolve().parents[2]
CELL = "gta5_uda_bf16_ddp4"
TWO = harness.merge(small("float32"), {"chips": 2})
AGREE = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}


def _over(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_correct(trace):
    """Untraced and traced (every rank under the profiler, rank 0's trace
    read): correct, the float32 step as close as one process's."""
    patch = harness.merge(TWO, {"traffic": {"trace_units": 2}})
    r = harness.run_cell(CELL, 2**31 + 29, 0.5, trace, time.perf_counter(), device="cpu",
                         patch=patch)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert r["device"]["count"] == 2, r
    if trace:
        assert r["device"]["window_s"] > 0 and "train_images_per_s" not in r["metrics"], r
    else:
        assert set(r["metrics"]) == {"train_images_per_s", "setup_s"}, r
    for k, tol in AGREE.items():
        assert r["checks"][k]["value"] < tol, (k, r["checks"][k])


def test_the_controls_fail():
    """One precision below (fp8) and half of each rank's share, computed by
    the reference over the global batch one share at a time."""
    limits = harness.load_cell(CELL, TWO).limits
    r = calibrate.readings(CELL, 37, "control", "cpu", harness.merge(small(), {"chips": 2}))
    assert _over(r["control"], limits) and _over(r["half_batch"], limits), r


def test_each_rank_on_its_own_gradient_fails():
    limits = harness.load_cell(CELL, TWO).limits
    r = calibrate.readings(CELL, 31, "fault", "cpu", TWO)
    assert _over(r["no_sync"], limits), r


KILL = textwrap.dedent("""
    import os, signal, sys, time
    import torch
    from portbench import harness
    from portbench.drivers import ddp_train
    from portbench.tests.small import small

    if __name__ == "__main__":
        cell = harness.load_cell("gta5_uda_bf16_ddp4",
                                 harness.merge(small("float32"), {"chips": 3}))
        d = ddp_train.Driver(cell, 41, torch.device("cpu"))
        print(" ".join(str(p.pid) for p in d.procs), flush=True)
        os.kill(d.procs[0].pid, signal.SIGKILL)
        harness.run_window(d, 60.0)
        print("the window ended", flush=True)
""")


def test_a_killed_rank_ends_the_run(tmp_path):
    script = tmp_path / "kill.py"
    script.write_text(KILL)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, str(script)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert p.returncode != 0 and "the window ended" not in p.stdout, (p.stdout, p.stderr[-2000:])
    assert time.monotonic() - t0 < 240
    pids = [int(x) for x in p.stdout.split()[:2]]
    time.sleep(1.0)
    assert not [pid for pid in pids if Path(f"/proc/{pid}").exists()
                and "Z" not in Path(f"/proc/{pid}/stat").read_text().split()[2]]


def _four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


@pytest.mark.card
def test_program_within_limits_on_four_cards():
    _four_cards()
    r = calibrate.readings(CELL, 2**33 + 505, "program")
    assert not _over(r["checks"], harness.load_cell(CELL).limits), r


@pytest.mark.card
@pytest.mark.parametrize("kind", ["control", "fault"])
def test_control_and_fault_fail_on_four_cards(kind):
    _four_cards()
    limits = harness.load_cell(CELL).limits
    r = calibrate.readings(CELL, 2**33 + 606, kind)
    if kind == "control":
        assert _over(r["control"], limits) and _over(r["half_batch"], limits), r
    else:
        assert _over(r["no_sync"], limits), r
