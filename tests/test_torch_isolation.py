"""The port stands alone: no JAX, no JAX package, no fallback that hides
a missing card or a failed kernel."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from maxsquareloss_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "maxsquareloss_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "maxsquareloss_tpu", "experiments", "tests", "tools")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_init_without_device_raises_without_cuda(monkeypatch):
    from maxsquareloss_torch.models.deeplabv2 import DeepLabV2Config, init_deeplabv2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_deeplabv2(DeepLabV2Config(blocks=(1, 1, 1, 1)), torch.Generator())


def test_kernel_wrapper_swallows_no_error():
    """No try/except in the kernel module: a build or launch failure raises."""
    tree = ast.parse((ROOT / "maxsquareloss_torch/kernels/fused_block.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_cuda_tensor_never_takes_the_plain_path():
    """The wrapper's CPU branch is keyed on the tensor's device alone."""
    src = (ROOT / "maxsquareloss_torch/kernels/fused_block.py").read_text()
    body = src.split("def fused_bottleneck(", 1)[1]
    assert body.count("fused_bottleneck_reference(") == 1
    assert 'if x.device.type == "cpu":\n        return fused_bottleneck_reference(' in body


def _run_chip_smoke(cwd: Path):
    """chip_smoke.py in a child process with no card visible."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
