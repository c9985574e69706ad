"""Nothing the harness or the reference loads is JAX, the JAX package or the
root ``bench`` module (top-level names compared whole); the reference loads
nothing of the port; without a card the command prints no result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "maxsquareloss_tpu", "bench"}


def _modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules("import portbench.reference.uda, portbench.reference.evaluate, "
                    "portbench.reference.lowp, portbench.compare, portbench.flops")
    assert not mods & (FORBIDDEN | {"maxsquareloss_torch"})


def test_a_run_loads_no_jax():
    code = ("import time\nfrom portbench import harness\nfrom portbench.tests.small import small\n"
            "r = harness.run_cell('synthia16_serve_b1_bf16', 1, 0.2, False, time.perf_counter(), "
            "device='cpu', patch=small())\nassert not harness.forbidden_modules()")
    mods = _modules(code)
    assert "maxsquareloss_torch" in mods and not mods & FORBIDDEN


def test_no_card_no_result(tmp_path):
    for where in (ROOT, tmp_path):
        if where is tmp_path:  # only BENCHMARK.json and the files under paths
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gta5_uda_bf16",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=where,
                           capture_output=True, text=True)
        assert p.returncode != 0 and p.stdout.strip() == ""
