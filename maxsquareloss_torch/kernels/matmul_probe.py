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
on the CUDA cores, bf16 products on the tensor cores (``wgmma`` where a
64-row tile fits, ``mma.sync`` elsewhere). The kernel is CUDA C++ in
``csrc/matmul_probe.cu`` (its header note gives the design), built by
``kernels/build.py`` and called through ``ctypes`` on PyTorch's current
stream. ``plan_probe`` holds the tile arithmetic: the route, the row tile,
the weight ring and the shared memory of a launch; ``pack_weight`` puts a
weight into the order the route streams it, once per call.

Types: float32 and bfloat16, for ``x``/``a``/``b`` (one type) and for
``out_dtype``. ``chain`` must be odd: the reference's output block is N wide.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. The kernel also needs K and N to be
multiples of 64 and a 16-byte aligned x.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from maxsquareloss_torch.kernels.build import CSRC, load, raise_on_error

SOURCE = CSRC / "matmul_probe.cu"
DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may take
PAD_BYTES = 16  # kPadBytes in the .cu
ROW_TILES = {torch.bfloat16: (64, 32), torch.float32: (32, 16)}  # largest first
# k-rows of a weight stage, in the planner's order of preference: the FMA
# loop is bound by its arithmetic and wants few, large stages; the mma.sync
# loop waits for the L2 and wants the deep ring of small ones
STAGE_ROWS = {torch.float32: (32, 16), torch.bfloat16: (16,)}
MIN_DEPTH, MAX_DEPTH = 2, 8  # stages of the weight ring (kMaxDepth in the .cu)
# the "wgmma" route: 64 rows, passes of 256 columns, stages of 32 k-rows
# (kWgBN, kWgKB in the .cu) without padding
WGMMA_TM, WGMMA_COLS, WGMMA_STAGE_ROWS = 64, 256, 32
SMEM_RESERVE = 1024  # static shared memory: the ring's barriers


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


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """How one launch tiles the chain (``plan_probe``)."""

    route: str        # "fma" (fp32, CUDA cores), "mma_sync" or "wgmma" (bf16, tensor cores)
    tm: int           # rows of a cell one block keeps resident
    block_cols: int   # output columns a block computes per pass (BN in the .cu)
    stage_rows: int   # k-rows of one weight stage (kb)
    depth: int        # stages of the weight ring
    elem_bytes: int
    stage_bytes: int
    smem_bytes: int   # dynamic shared memory: both activation buffers and the ring

    @property
    def bytes_in_flight(self) -> int:
        """Weight bytes a block has on their way while it multiplies one stage."""
        return (self.depth - 1) * self.stage_bytes

    @property
    def flop_per_l2_weight_byte(self) -> float:
        """Every block streams each whole weight from L2 for its own rows."""
        return 2.0 * self.tm / self.elem_bytes

    def tiles(self, m: int) -> int:
        """Row tiles that hold rows of a cell of M rows."""
        return -(-m // self.tm)


def _block_cols(dtype: torch.dtype, tm: int) -> int:
    """``block_cols`` in the .cu: bf16 warps are 32 x 64 tiles, fp32 warps
    cover 8 rows x 128 columns."""
    return 64 * (8 // (tm // 32)) if dtype == torch.bfloat16 else 128 * (8 // (tm // 8))


def plan_probe(dtype: torch.dtype, k: int, n: int) -> ProbePlan:
    """The largest row tile whose two activation buffers leave room for a
    weight ring of at least ``MIN_DEPTH`` stages, with the first stage size
    of ``STAGE_ROWS`` that gives such a ring, as deep as the room allows."""
    es = torch.finfo(dtype).bits // 8
    pad = PAD_BYTES // es
    if dtype == torch.bfloat16 and k % WGMMA_COLS == 0 and n % WGMMA_COLS == 0:
        # both activation tiles in wgmma's core-matrix layout, no padding
        buffers = es * WGMMA_TM * (k + n)
        stage = es * WGMMA_STAGE_ROWS * WGMMA_COLS
        depth = min(MAX_DEPTH, (SMEM_LIMIT - SMEM_RESERVE - buffers) // stage)
        if depth >= MIN_DEPTH:
            return ProbePlan("wgmma", WGMMA_TM, WGMMA_COLS, WGMMA_STAGE_ROWS, depth,
                             es, stage, buffers + depth * stage)
    for tm in ROW_TILES[dtype]:
        bn = _block_cols(dtype, tm)
        buffers = es * tm * (k + pad + n + pad)
        for kb in STAGE_ROWS[dtype]:
            if k % kb or n % kb:
                continue
            stage = es * kb * (bn + pad)
            depth = min(MAX_DEPTH, (SMEM_LIMIT - SMEM_RESERVE - buffers) // stage)
            if depth >= MIN_DEPTH:
                route = "mma_sync" if dtype == torch.bfloat16 else "fma"
                return ProbePlan(route, tm, bn, kb, depth, es, stage,
                                 buffers + depth * stage)
    raise ValueError(f"matmul probe: K={k}, N={n} in {dtype} do not fit one block's "
                     f"shared memory at any row tile {ROW_TILES[dtype]}")


def pack_weight(w: torch.Tensor, plan: ProbePlan) -> torch.Tensor:
    """A (Kin, Nout) weight in the order the plan's route streams it, so that
    a stage (``plan.stage_rows`` k-rows of one pass of ``plan.block_cols``
    output columns) is one contiguous run of ``plan.stage_bytes`` that a
    single bulk copy drops into shared memory as the kernel reads it.

    "wgmma": (passes, Kin/8, 32, 8, 8): for every 8 k-rows the pass's 32
    blocks of 8 columns as 8 x 8 core matrices of 128 contiguous bytes.
    "mma_sync" and "fma": (passes, Kin, block_cols + pad): the pass's columns
    row by row, every row padded by 16 bytes, the last pass by zero columns."""
    kin, nout = w.shape
    bn = plan.block_cols
    if plan.route == "wgmma":
        return w.reshape(kin // 8, 8, nout // bn, bn // 8, 8).permute(2, 0, 3, 1, 4).contiguous()
    passes = -(-nout // bn)
    rows = torch.nn.functional.pad(w, (0, passes * bn - nout)).reshape(kin, passes, bn)
    return torch.nn.functional.pad(rows.permute(1, 0, 2), (0, PAD_BYTES // plan.elem_bytes))


def unpack_weight(packed: torch.Tensor, plan: ProbePlan, nout: int) -> torch.Tensor:
    """The (Kin, Nout) weight back from ``pack_weight``'s order."""
    if plan.route == "wgmma":
        passes, kblocks, nblocks, _, _ = packed.shape
        return packed.permute(1, 3, 0, 2, 4).reshape(kblocks * 8, passes * nblocks * 8)
    passes, kin, _ = packed.shape
    bn = plan.block_cols
    return packed[:, :, :bn].permute(1, 0, 2).reshape(kin, passes * bn)[:, :nout]


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msl_matmul_probe_wgmma.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, p, p]
    lib.msl_matmul_probe_wgmma.restype = i
    lib.msl_matmul_probe.argtypes = [i, i, i, i, i, p, p, p, p, i, i, i, i, i, p, p, p]
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
    if x.data_ptr() % 16:
        raise ValueError("matmul probe: x must be 16-byte aligned")


def _launch(t, x, a, b, chain: int, out_dtype: torch.dtype) -> torch.Tensor:
    c, m, k = x.shape
    n = a.shape[1]
    if k % 64 or n % 64:
        raise ValueError(f"matmul probe: the kernel needs K and N multiples of 64, got {k}, {n}")
    bf16 = x.dtype == torch.bfloat16
    plan = plan_probe(x.dtype, k, n)
    partial = torch.empty((c, plan.tiles(m), n), dtype=torch.float32, device=x.device)
    out = torch.empty((c, 1, n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        # packing is part of the launch: it is timed with it
        wa, wb = pack_weight(a, plan), pack_weight(b, plan)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route == "wgmma":
            err = lib.msl_matmul_probe_wgmma(
                int(out_dtype == torch.bfloat16), plan.depth, t.data_ptr(), x.data_ptr(),
                wa.data_ptr(), wb.data_ptr(), c, m, k, n, chain, partial.data_ptr(),
                out.data_ptr(), stream,
            )
        else:
            err = lib.msl_matmul_probe(
                int(bf16), int(out_dtype == torch.bfloat16), plan.tm, plan.stage_rows,
                plan.depth, t.data_ptr(), x.data_ptr(), wa.data_ptr(), wb.data_ptr(), c, m, k,
                n, chain, partial.data_ptr(), out.data_ptr(), stream,
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
