"""Fused stride-1 identity bottleneck: the Hopper kernel, its wrappers,
its autograd Function and its plain PyTorch version.

Port of ``experiments/retired_pallas/fused_block.py``: ``_kernel_body`` /
``fused_bottleneck_padded`` (forward with ``emit=False``, the eval path)
and the training ``custom_vjp`` (``_fwd`` with ``emit=True``, ``_bwd``).
The kernel is CUDA C++ in ``csrc/fused_bottleneck.cu`` (its header note
gives the design and tile), built by ``kernels/build.py`` and called
through ``ctypes`` on PyTorch's current stream.

The wrappers take x as an NCHW tensor in ``torch.channels_last`` memory
format (physically NHWC), HWIO conv kernels as in the JAX package, and the
folded frozen-BN scale/bias vectors. On a CPU tensor they run the plain
version; on a CUDA tensor they launch the kernel or raise.

- ``fused_bottleneck``: out only (eval, no grad).
- ``fused_bottleneck_emit``: (out, h1, h2), the training forward.
- ``FusedBottleneckFn.apply``: differentiable in x and the three conv
  kernels; its backward is the adjoint chain of ``_bwd``
  (``bottleneck_backward``) as PyTorch ops over the saved x, h1, h2 and
  out, as the JAX package left it to XLA.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from maxsquareloss_torch.kernels.build import CSRC, load, raise_on_error

SOURCE = CSRC / "fused_bottleneck.cu"

PIXEL_TILE = 8         # pixels per thread tile (kPx in the .cu)
SMEM_BLOCK_MAX = 232448  # bytes of shared memory one block may use on sm_90
SMEM_SM = 233472         # bytes of shared memory per SM on sm_90
BLOCK_SMEM_RESERVED = 1024  # bytes the runtime reserves per resident block


def fused_bottleneck_emit_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation):
    """The plain version: ``F.conv2d`` chain + affine frozen BN + ReLU;
    (out, h1, h2), each channels_last (h1, h2: (N, Cmid, H, W))."""
    def bn(y, s, b):
        return y * s.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    h1 = F.relu(bn(F.conv2d(x, w1.permute(3, 2, 0, 1)), s1, b1))
    h2 = F.relu(bn(
        F.conv2d(h1, w2.permute(3, 2, 0, 1), padding=dilation, dilation=dilation),
        s2, b2,
    ))
    y = F.relu(bn(F.conv2d(h2, w3.permute(3, 2, 0, 1)), s3, b3) + x)
    return tuple(t.contiguous(memory_format=torch.channels_last) for t in (y, h1, h2))


def fused_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation):
    """The plain version of the block's output (differentiable)."""
    return fused_bottleneck_emit_reference(
        x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation)[0]


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


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msl_fused_bottleneck_f32.argtypes = [p] * 13 + [i] * 11 + [p]
    lib.msl_fused_bottleneck_f32.restype = i
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


def _launch(args, dilation: int, emit: bool):
    """One kernel launch on CUDA tensors: out, and h1/h2 with ``emit``."""
    x, w1 = args[0], args[1]
    n, cin, h, w = x.shape
    cmid = w1.shape[-1]
    if cin % 4 or cmid % 4:
        raise ValueError(f"fused bottleneck: Cin {cin} and Cmid {cmid} must be multiples of 4")
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("fused bottleneck: every tensor must be 16-byte aligned")
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    tw, rs, segs, threads, smem = plan_tiles(n, h, w, cmid, dilation, sm_count)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    hs = tuple(
        torch.empty((n, cmid, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
        for _ in range(2 if emit else 0)
    )
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.msl_fused_bottleneck_f32(
            *(t.data_ptr() for t in args), out.data_ptr(),
            *((t.data_ptr() for t in hs) if emit else (None, None)),
            n, h, w, cin, cmid, dilation, tw, rs, segs, threads, smem, stream,
        )
    raise_on_error(err, lib, "fused bottleneck")
    return (out, *hs)


def fused_bottleneck_emit(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation: int):
    """The training forward: (out, h1, h2) in one kernel, with
    h1 = relu(bn1(conv1 x)) and h2 = relu(bn2(conv2 h1)), each
    (N, Cmid, H, W) channels_last; arguments as ``fused_bottleneck``."""
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args, dilation)
    if x.device.type == "cpu":
        return fused_bottleneck_emit_reference(*args, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused bottleneck: no kernel for device {x.device}")
    outs = _launch(args, dilation, emit=True)
    fused_bottleneck_emit.launches += 1
    return outs


fused_bottleneck_emit.launches = 0


def bottleneck_backward(dy, x, h1, h2, out, w1, w2, w3, s1, s2, s3, dilation: int):
    """Adjoints of the block from its saved tensors (``_bwd`` of the JAX
    package's fused block): relu masks from out, h2 and h1, the BN scales,
    dw1/dw3 and the 1x1 adjoints as matrix products over the NHWC pixel
    rows, and the dilated 3x3's adjoints as one ``convolution_backward``.
    Returns (dx channels_last, dw1, dw2, dw3 HWIO)."""
    n, cin, h, w = x.shape
    cmid = h1.shape[1]

    def rows(t):  # (N, C, H, W) → (N*H*W, C); a view for channels_last
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])

    dz3 = torch.where(rows(out) > 0, rows(dy), 0.0)         # relu' ⊙ dy
    dz3c = dz3 * s3                                         # through bn3's scale
    dw3 = rows(h2).T @ dz3c                                 # (Cmid, Cin)
    dh2 = dz3c @ w3.view(cmid, cin).T
    dacc = torch.where(rows(h2) > 0, dh2 * s2, 0.0)
    dacc = dacc.view(n, h, w, cmid).permute(0, 3, 1, 2)     # channels_last NCHW
    w2_oihw = w2.permute(3, 2, 0, 1)
    dh1, dw2, _ = torch.ops.aten.convolution_backward(
        dacc, h1, w2_oihw, None, [1, 1], [dilation, dilation],
        [dilation, dilation], False, [0, 0], 1, [True, True, False],
    )
    dz1 = torch.where(rows(h1) > 0, rows(dh1) * s1, 0.0)
    dw1 = rows(x).T @ dz1                                   # (Cin, Cmid)
    dx = dz1 @ w1.view(cin, cmid).T + dz3
    return (dx.view(n, h, w, cin).permute(0, 3, 1, 2), dw1.view(1, 1, cin, cmid),
            dw2.permute(2, 3, 1, 0), dw3.view(1, 1, cmid, cin))


class FusedBottleneckFn(torch.autograd.Function):
    """The identity block for training, with a gradient for x and the three
    HWIO kernels (frozen BN gets none); ``apply`` takes the arguments of
    ``fused_bottleneck``. Forward: ``fused_bottleneck_emit`` on kernels
    made contiguous here, so strided views of the convs' weights may come
    in; backward: ``bottleneck_backward`` over the saved x, h1, h2, out."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation):
        w1, w2, w3 = (w.contiguous() for w in (w1, w2, w3))
        out, h1, h2 = fused_bottleneck_emit(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation)
        ctx.save_for_backward(x, h1, h2, out, w1, w2, w3, s1, s2, s3)
        ctx.dilation = dilation
        return out

    @staticmethod
    def backward(ctx, dy):
        grads = bottleneck_backward(dy, *ctx.saved_tensors, ctx.dilation)
        return (*grads, *(None,) * 7)


def fused_bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation: int):
    """Stride-1 identity-residual bottleneck in one kernel (eval: no h1/h2).

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
    (out,) = _launch(args, dilation, emit=False)
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
