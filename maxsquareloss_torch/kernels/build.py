"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/``, named by a hash of its content
and the flags, so it compiles once per content; the library is loaded with
``ctypes``. A source may be built more than once with other ``-D``
defines (the fused bottleneck's bf16 instance), each into a library of
its own, so one build never waits on the other's instances. Nothing here runs at import: the CPU tests import every module,
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
def build(source: Path, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` with the ``-D`` flags ``defines`` into ``build/``
    (once per content and flags); the library path."""
    src = source.read_bytes()
    flags = (*NVCC_FLAGS, *defines)
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"{source.stem}-{tag}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(source: Path, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library of ``source`` with ``defines``; the caller
    declares the argtypes of its launch functions."""
    lib = ctypes.CDLL(str(build(source, defines)))
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
