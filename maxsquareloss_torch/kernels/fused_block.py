"""Fused stride-1 identity bottleneck: the Hopper kernel, its wrapper and
its plain PyTorch version.

Port of ``experiments/retired_pallas/fused_block.py`` (``_kernel_body`` /
``fused_bottleneck_padded``, forward with ``emit=False``). The kernel is
CUDA C++ in ``csrc/fused_bottleneck.cu`` (its header note gives the design
and tile), compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at first
use and called through ``ctypes`` on PyTorch's current stream.

``fused_bottleneck`` takes x as an NCHW tensor in ``torch.channels_last``
memory format (physically NHWC), HWIO conv kernels as in the JAX package,
and the folded frozen-BN scale/bias vectors. On a CPU tensor it runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_bottleneck.cu"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

PIXEL_TILE = 8         # pixels per thread tile (kPx in the .cu)
SMEM_BLOCK_MAX = 232448  # bytes of shared memory one block may use on sm_90
SMEM_SM = 233472         # bytes of shared memory per SM on sm_90
BLOCK_SMEM_RESERVED = 1024  # bytes the runtime reserves per resident block


def fused_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation):
    """The plain version: ``F.conv2d`` chain + affine frozen BN + ReLU."""
    def bn(y, s, b):
        return y * s.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    h = F.relu(bn(F.conv2d(x, w1.permute(3, 2, 0, 1)), s1, b1))
    h = F.relu(bn(
        F.conv2d(h, w2.permute(3, 2, 0, 1), padding=dilation, dilation=dilation),
        s2, b2,
    ))
    y = F.relu(bn(F.conv2d(h, w3.permute(3, 2, 0, 1)), s3, b3) + x)
    return y.contiguous(memory_format=torch.channels_last)


def smem_bytes(tw: int, cmid: int, d: int) -> int:
    """Shared memory of one block: 3 h1 rows of TW+2d pixels + TW h2 pixels."""
    return 4 * cmid * (3 * (tw + 2 * d) + tw)


def plan_tiles(n: int, h: int, w: int, cmid: int, d: int, sm_count: int):
    """Tile choice for one launch → (TW, RS, S, threads, smem bytes).

    TW: columns per block, a multiple of the 8-pixel thread tile, at most
    min(64, 8192 / Cmid) and within the shared-memory limit, balanced over
    the width so the ragged last strip wastes little. threads: 512 where
    the shared memory leaves room for one block per SM, else 256, so that
    16 warps stay resident either way (measured on an H100: PERF.md). RS: output
    rows per chain segment, S: segments per chain (a chain is one residue
    class of the rows mod d). S trades conv1 recompute (2 extra h1 rows per
    segment) against filling the SMs: it minimises waves * (RS + 0.5).
    """
    tw_max = max(PIXEL_TILE, min(64, 8192 // cmid))
    while tw_max > PIXEL_TILE and smem_bytes(tw_max, cmid, d) > SMEM_BLOCK_MAX:
        tw_max //= 2
    ncols = math.ceil(w / tw_max)
    tw = math.ceil(math.ceil(w / ncols) / PIXEL_TILE) * PIXEL_TILE
    smem = smem_bytes(tw, cmid, d)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(
            f"fused bottleneck: Cmid={cmid}, d={d} needs {smem} B of shared "
            f"memory at the smallest tile; at most {SMEM_BLOCK_MAX} B fit"
        )
    per_sm = max(1, min(2, SMEM_SM // (smem + BLOCK_SMEM_RESERVED)))
    threads = 512 if per_sm == 1 else 256
    slots = sm_count * per_sm
    chain = math.ceil(h / d)
    best = None
    for segs in range(1, chain + 1):
        rs = math.ceil(chain / segs)
        s = math.ceil(chain / rs)
        blocks = ncols * n * d * s
        cost = math.ceil(blocks / slots) * (rs + 0.5)
        if best is None or cost < best[0]:
            best = (cost, rs, s)
    _, rs, s = best
    return tw, rs, s, threads, smem


@functools.lru_cache(maxsize=1)
def build() -> Path:
    """Compile the kernel into ``build/`` (once per source content)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"fused_bottleneck-{tag}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msl_fused_bottleneck_f32.argtypes = [p] * 11 + [i] * 11 + [p]
    lib.msl_fused_bottleneck_f32.restype = i
    lib.msl_cuda_error_string.argtypes = [i]
    lib.msl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation):
    if x.dim() != 4:
        raise ValueError(f"fused bottleneck: x must be 4-D NCHW, got {tuple(x.shape)}")
    n, cin, h, w = x.shape
    cmid = w1.shape[-1]
    want = {
        "w1": (w1, (1, 1, cin, cmid)), "w2": (w2, (3, 3, cmid, cmid)),
        "w3": (w3, (1, 1, cmid, cin)),
        "s1": (s1, (cmid,)), "b1": (b1, (cmid,)), "s2": (s2, (cmid,)),
        "b2": (b2, (cmid,)), "s3": (s3, (cin,)), "b3": (b3, (cin,)),
    }
    for name, (t, shape) in {"x": (x, tuple(x.shape)), **want}.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused bottleneck: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused bottleneck: {name} is {t.dtype}; only float32 is supported")
        if t.device != x.device:
            raise ValueError(f"fused bottleneck: {name} is on {t.device}, x on {x.device}")
        if name != "x" and not t.is_contiguous():
            raise ValueError(f"fused bottleneck: {name} must be contiguous")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused bottleneck: x must be channels_last contiguous")
    if dilation < 1:
        raise ValueError(f"fused bottleneck: dilation {dilation} < 1")


def fused_bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation: int):
    """Stride-1 identity-residual bottleneck in one kernel.

    Args:
      x: (N, Cin, H, W) float32, ``torch.channels_last`` contiguous.
      w1/w2/w3: HWIO kernels (1,1,Cin,Cmid), (3,3,Cmid,Cmid), (1,1,Cmid,Cin).
      s1..b3: folded frozen-BN scale/bias vectors.
      dilation: conv2's dilation (and zero padding).
    Returns:
      (N, Cin, H, W) float32, channels_last.
    """
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args, dilation)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(*args, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused bottleneck: no kernel for device {x.device}")
    n, cin, h, w = x.shape
    cmid = w1.shape[-1]
    if cin % 4 or cmid % 4:
        raise ValueError(f"fused bottleneck: Cin {cin} and Cmid {cmid} must be multiples of 4")
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("fused bottleneck: every tensor must be 16-byte aligned")
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    tw, rs, segs, threads, smem = plan_tiles(n, h, w, cmid, dilation, sm_count)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.msl_fused_bottleneck_f32(
            *(t.data_ptr() for t in args), out.data_ptr(),
            n, h, w, cin, cmid, dilation, tw, rs, segs, threads, smem, stream,
        )
    if err != 0:
        raise RuntimeError(
            "fused bottleneck launch failed: CUDA error "
            f"{err} ({lib.msl_cuda_error_string(err).decode()})"
        )
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
