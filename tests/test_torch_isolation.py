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
    """The eval wrapper's CPU branch is keyed on the tensor's device alone:
    it calls the custom op, whose dispatch on the device picks the CPU
    implementation (the plain version, and only there) or the CUDA one
    (the kernel launch, never the plain version)."""
    src = (ROOT / "maxsquareloss_torch/kernels/fused_block.py").read_text()
    wrapper = _function_source("kernels/fused_block.py", "fused_bottleneck")
    assert "torch.ops.msl.fused_bottleneck(" in wrapper and "_reference(" not in wrapper
    cpu = _function_source("kernels/fused_block.py", "_fused_bottleneck_cpu")
    cuda = _function_source("kernels/fused_block.py", "_fused_bottleneck_cuda")
    assert cpu.count("fused_bottleneck_reference(") == 1
    assert "_reference(" not in cuda and "_launch(" in cuda
    assert src.count("fused_bottleneck_reference(") == 2  # its def and the CPU implementation
    assert '@_fused_bottleneck_op.register_kernel("cpu")\ndef _fused_bottleneck_cpu(' in src
    assert '@_fused_bottleneck_op.register_kernel("cuda")\ndef _fused_bottleneck_cuda(' in src


@pytest.mark.parametrize("module", ["kernels/fused_loss.py", "kernels/build.py",
                                    "kernels/matmul_probe.py", "data/hostops.py"])
def test_new_kernel_modules_swallow_no_error(module):
    """No try/except in the kernel modules, the build helper or the host
    extension's build and wrappers."""
    tree = ast.parse((ROOT / "maxsquareloss_torch" / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def _function_source(module: str, name: str) -> str:
    src = (ROOT / "maxsquareloss_torch" / module).read_text()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(src, node)


@pytest.mark.parametrize(
    "module,wrapper,plain,tensor",
    [
        ("kernels/fused_block.py", "fused_bottleneck_emit", "fused_bottleneck_emit_reference", "x"),
        ("kernels/fused_loss.py", "fused_iw_max_square_loss",
         "fused_iw_max_square_loss_reference", "logits"),
        ("kernels/fused_loss.py", "fused_max_square_loss", "fused_max_square_loss_reference",
         "logits"),
        ("kernels/matmul_probe.py", "matmul_chain", "matmul_chain_plain", "x"),
    ],
)
def test_new_wrappers_take_the_plain_path_on_cpu_tensors_only(module, wrapper, plain, tensor):
    """Each new wrapper's plain branch is keyed on its tensor's device alone,
    and the wrapper calls its plain version there and nowhere else."""
    body = _function_source(module, wrapper)
    assert body.count(f"{plain}(") == 1
    assert f'if {tensor}.device.type == "cpu":\n        return {plain}(' in body
    assert f'if {tensor}.device.type != "cuda":\n        raise ValueError(' in body


def test_training_path_imports_without_pil():
    """The trainers, the CLIs and chip_smoke.py import with PIL missing: a
    trainer over in-memory data needs no image library."""
    code = ("import sys; sys.modules['PIL'] = None; "
            "import maxsquareloss_torch.tools.solve_gta5, maxsquareloss_torch.tools.train_source, "
            "maxsquareloss_torch.experiments.bench_matmul, chip_smoke")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


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
