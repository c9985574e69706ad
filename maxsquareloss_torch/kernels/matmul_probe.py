"""Matmul-chain calibration probe: the Hopper kernel and its plain PyTorch
version.

Port of the Pallas kernel in ``experiments/bench_pallas_matmul.py`` (the
MXU calibration probe). Per cell ``c`` of ``x`` (C, M, K):
``y = x[c] + t``, then ``chain`` times ``y = relu(y @ W_i)`` with W
alternating ``a`` (K, N) and ``b`` (N, K), each product accumulated in
fp32, cast to ``out_dtype``, passed through the ReLU and cast back to x's
type; the result is the fp32 sum of y over the rows, (C, 1, N). It measures
what the fused bottleneck's structure (a row tile resident in shared
memory, weights streamed from L2) reaches on the card: fp32 products as FMAs
on the CUDA cores, bf16 products on the tensor cores. The kernel is CUDA C++
in ``csrc/matmul_probe.cu`` (its header note gives the design), built by
``kernels/build.py`` and called through ``ctypes`` on PyTorch's current
stream.

Types: float32 and bfloat16, for ``x``/``a``/``b`` (one type) and for
``out_dtype``. ``chain`` must be odd: the reference's output block is N wide.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. The kernel also needs K and N to be
multiples of 64.
"""

from __future__ import annotations

import ctypes

import torch

from maxsquareloss_torch.kernels.build import CSRC, load, raise_on_error

SOURCE = CSRC / "matmul_probe.cu"
DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may take
BK, PAD_BYTES = 16, 16  # kBK, kPadBytes in the .cu
ROW_TILES = {torch.bfloat16: (64, 32), torch.float32: (32, 16)}  # largest first


def matmul_chain_plain(t: torch.Tensor, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       chain: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: the chain as ``torch.matmul`` on fp32 upcasts, cast
    as the kernel casts. Returns (C, 1, N) float32."""
    dtype = x.dtype
    y = x + t.reshape(()).to(dtype)
    for i in range(chain):
        w = a if i % 2 == 0 else b
        y = torch.relu(torch.matmul(y.float(), w.float()).to(out_dtype)).to(dtype)
    return y.float().sum(dim=1, keepdim=True)


def block_cols(dtype: torch.dtype, tm: int) -> int:
    """Output columns a block computes per pass (``block_cols`` in the .cu)."""
    return 64 * (8 // (tm // 32)) if dtype == torch.bfloat16 else 256 * (8 // (tm // 4))


def smem_bytes(dtype: torch.dtype, tm: int, k: int, n: int) -> int:
    """Dynamic shared memory of a launch: the TM x K and TM x N activation
    buffers and two weight stages, every row padded by 16 bytes."""
    es = torch.finfo(dtype).bits // 8
    pad = PAD_BYTES // es
    return es * (tm * (k + pad) + tm * (n + pad) + 2 * BK * (block_cols(dtype, tm) + pad))


def plan_rows(dtype: torch.dtype, k: int, n: int) -> int:
    """The largest row tile whose buffers fit a block's shared memory."""
    for tm in ROW_TILES[dtype]:
        if smem_bytes(dtype, tm, k, n) <= SMEM_LIMIT:
            return tm
    raise ValueError(f"matmul probe: K={k}, N={n} in {dtype} do not fit one block's "
                     f"shared memory at any row tile {ROW_TILES[dtype]}")


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msl_matmul_probe.argtypes = [i, i, i, p, p, p, p, i, i, i, i, i, p, p, p]
    lib.msl_matmul_probe.restype = i
    return lib


def _check(t, x, a, b, chain: int, out_dtype: torch.dtype) -> None:
    if chain < 1 or chain % 2 == 0:
        raise ValueError(f"matmul probe: chain {chain} must be odd (the output is N wide)")
    if x.dim() != 3:
        raise ValueError(f"matmul probe: x must be (C, M, K), got {tuple(x.shape)}")
    _, _, k = x.shape
    n = a.shape[-1] if a.dim() == 2 else -1
    if tuple(a.shape) != (k, n) or tuple(b.shape) != (n, k):
        raise ValueError(f"matmul probe: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"must be (K, N) and (N, K) with K = {k}")
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"matmul probe: types {x.dtype} -> {out_dtype}; "
                        f"the kernel takes {DTYPES}")
    if t.numel() != 1 or t.dtype != torch.float32:
        raise ValueError(f"matmul probe: t must be one float32, got {t.dtype} {tuple(t.shape)}")
    for name, v in (("a", a), ("b", b), ("t", t)):
        if v.device != x.device:
            raise ValueError(f"matmul probe: {name} is on {v.device}, x on {x.device}")
        if name != "t" and v.dtype != x.dtype:
            raise TypeError(f"matmul probe: {name} is {v.dtype}, x is {x.dtype}")
    for name, v in (("x", x), ("a", a), ("b", b), ("t", t)):
        if not v.is_contiguous():
            raise ValueError(f"matmul probe: {name} must be contiguous")


def _launch(t, x, a, b, chain: int, out_dtype: torch.dtype) -> torch.Tensor:
    c, m, k = x.shape
    n = a.shape[1]
    if k % 64 or n % 64:
        raise ValueError(f"matmul probe: the kernel needs K and N multiples of 64, got {k}, {n}")
    bf16 = x.dtype == torch.bfloat16
    tm = plan_rows(x.dtype, k, n)
    tiles = -(-m // tm)
    partial = torch.empty((c, tiles, n), dtype=torch.float32, device=x.device)
    out = torch.empty((c, 1, n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.msl_matmul_probe(
            int(bf16), int(out_dtype == torch.bfloat16), tm, t.data_ptr(), x.data_ptr(),
            a.data_ptr(), b.data_ptr(), c, m, k, n, chain, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(err, lib, "matmul probe")
    matmul_chain.launches += 1
    return out


def matmul_chain(t: torch.Tensor, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 chain: int = 3, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The probe's chain: ``t`` one float32, ``x`` (C, M, K), ``a`` (K, N),
    ``b`` (N, K) in float32 or bfloat16; returns (C, 1, N) float32."""
    _check(t, x, a, b, chain, out_dtype)
    if x.device.type == "cpu":
        return matmul_chain_plain(t, x, a, b, chain, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"matmul probe: no kernel for device {x.device}")
    return _launch(t, x, a, b, chain, out_dtype)


matmul_chain.launches = 0
