"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/``, named by a hash of its content
and the flags, so it compiles once per content; the library is loaded with
``ctypes``. Nothing here runs at import: the CPU tests import every module,
and a machine without a card has no ``nvcc``. Every source exports
``msl_cuda_error_string`` beside its launch functions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


@functools.lru_cache(maxsize=None)
def build(source: Path) -> Path:
    """Compile ``source`` into ``build/`` (once per content); the library path."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"{source.stem}-{tag}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source``; the caller declares the argtypes of
    its launch functions."""
    lib = ctypes.CDLL(str(build(source)))
    lib.msl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a launch returned a CUDA error (``msl_cuda_error_string``)."""
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.msl_cuda_error_string(err).decode()})"
        )
