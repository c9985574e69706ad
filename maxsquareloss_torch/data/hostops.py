"""The port's host extension (``maxsquareloss_torch/csrc/hostops.cpp``): PNG
decode written over zlib (no libpng), LUT remap of labels, caffe
normalization and a Gaussian blur byte-exact against Pillow's, each one pass
in C++ with the GIL released.

The extension is built by ``g++`` at its first use into the git-ignored
``build/``, named by a hash of the source, the flags, the Python headers and
the compiler's target (``-march=native`` differs between machines), under a
file lock, so parallel processes build it once. ``available()`` is False
only where no ``g++`` or no ``zlib.h`` is found; a compile error raises with
the compiler's output. ``calls()`` counts the decodes and blurs that went
through the extension in this process, so a run can show which of its
samples the extension served.
"""

from __future__ import annotations

import fcntl
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hostops.cpp"
BUILD_DIR = SOURCE.parents[2] / "build"
MODULE = "_msl_hostops"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_CALLS = {"decode": 0, "blur": 0}  # loader threads call in at once
_CALLS_LOCK = threading.Lock()


def _run(argv: list[str], stdin: str = "") -> subprocess.CompletedProcess:
    return subprocess.run(argv, input=stdin, capture_output=True, text=True)


@functools.lru_cache(maxsize=None)
def _compiler() -> str | None:
    """``g++`` where it is on the PATH and preprocesses ``zlib.h``; else None."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    probe = _run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull], "#include <zlib.h>\n")
    return gxx if probe.returncode == 0 else None


def available() -> bool:
    """Whether the extension can be built here (``g++`` and ``zlib.h``)."""
    return _compiler() is not None


@functools.lru_cache(maxsize=None)
def build() -> Path:
    """Compile the extension into ``build/`` once per content and target; its path."""
    gxx = _compiler()
    if gxx is None:
        raise RuntimeError("the host extension needs g++ and zlib.h, and this machine lacks one")
    flags = (*CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}")
    # the compiler's predefined macros name its version and the ISA that
    # -march=native selects on this machine
    target = _run([gxx, *flags, "-dM", "-E", "-x", "c++", "-"]).stdout
    key = SOURCE.read_bytes() + "\0".join((gxx, *flags, target)).encode()
    lib = BUILD_DIR / f"{MODULE}-{hashlib.sha256(key).hexdigest()[:12]}" \
                      f"{sysconfig.get_config_var('EXT_SUFFIX')}"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{MODULE}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = _run([gxx, *flags, "-o", str(tmp), str(SOURCE), "-lz"])
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, lib)
    return lib


def calls() -> dict[str, int]:
    """Calls that went through the extension in this process so far:
    ``decode`` (any of the three decodes) and ``blur``."""
    with _CALLS_LOCK:
        return dict(_CALLS)


def _counted(kind: str):
    """The extension module, one ``kind`` call counted."""
    module = _ext()
    with _CALLS_LOCK:
        _CALLS[kind] += 1
    return module


@functools.lru_cache(maxsize=None)
def _ext():
    lib = str(build())
    loader = importlib.machinery.ExtensionFileLoader(MODULE, lib)
    module = importlib.util.module_from_spec(
        importlib.util.spec_from_file_location(MODULE, lib, loader=loader))
    loader.exec_module(module)
    return module


def decode_png(data: bytes, expand_rgb: bool = True) -> np.ndarray:
    """PNG bytes → (H, W[, C]): 8-bit RGB when ``expand_rgb``, else the
    stored samples (uint16 at 16 bits, palette indices, sub-8-bit unpacked)."""
    buf, h, w, c, depth = _counted("decode").decode_png(data, expand_rgb)
    arr = np.frombuffer(buf, dtype=np.uint16 if depth == 16 else np.uint8)
    return arr.reshape((h, w, c) if c > 1 else (h, w))


def decode_remap(data: bytes, lut: np.ndarray) -> np.ndarray:
    """Label PNG bytes + int32 LUT → int32 (H, W) of each pixel's first
    stored sample through the LUT (ids past its end take its last entry)."""
    lut = np.ascontiguousarray(lut, dtype=np.int32)
    buf, h, w = _counted("decode").decode_remap(data, lut)
    return np.frombuffer(buf, dtype=np.int32).reshape(h, w)


def decode_normalize_bgr(data: bytes, mean_bgr) -> np.ndarray:
    """RGB PNG bytes → float32 (H, W, 3) BGR − mean (the caffe normalization)."""
    m = np.asarray(mean_bgr, dtype=np.float32)
    buf, h, w = _counted("decode").decode_normalize_bgr(data, *(float(v) for v in m[:3]))
    return np.frombuffer(buf, dtype=np.float32).reshape(h, w, 3)


def gaussian_blur(arr: np.ndarray, radius: float) -> np.ndarray:
    """uint8 (H, W[, C]) → Pillow's ``GaussianBlur(radius)`` of it, byte for byte."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    c = arr.shape[2] if arr.ndim == 3 else 1
    out = _counted("blur").gaussian_blur(arr, h, w, c, float(radius))
    return np.frombuffer(out, dtype=np.uint8).reshape(arr.shape)
