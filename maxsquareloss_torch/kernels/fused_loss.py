"""Fused softmax + (IW) max-square loss: the Hopper kernels, their
``autograd.Function`` and their plain PyTorch versions.

Port of ``experiments/retired_pallas/fused_loss.py``
(``fused_iw_max_square_loss``, ``fused_max_square_loss``). The kernels are
CUDA C++ in ``csrc/fused_loss.cu`` (its header note gives the design),
built by ``kernels/build.py`` and called through ``ctypes`` on PyTorch's
current stream. Both directions read the logits once; the backward
recomputes the softmax, so nothing but the logits (and the weights) is
saved, and the (N, H, W, C) probabilities never reach device memory. A
block walks its pixels in tiles of 256 that one thread fetches with bulk
asynchronous copies, one or two tiles ahead of the arithmetic.

Each wrapper takes contiguous NHWC float32 logits with C <= 32. On a CPU
tensor it runs the plain version (autograd through PyTorch ops); on a CUDA
tensor it launches the kernel or raises. The weights get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from maxsquareloss_torch.kernels.build import CSRC, load, raise_on_error

SOURCE = CSRC / "fused_loss.cu"
MAX_CLASSES = 32
THREADS = 256           # kThreads in the .cu: pixels per tile
PX_PER_BLOCK = 8 * THREADS  # pixels per block: the forward's partial granularity


def fused_iw_max_square_loss_reference(logits: torch.Tensor, weights: torch.Tensor,
                                       normalizer: float | None = None):
    """The plain version: ``-sum(p^2 * w[n, argmax p]) / (N * C)``
    (``normalizer`` in place of N * C)."""
    n, _, _, c = logits.shape
    p = torch.softmax(logits, dim=-1)
    amax = p.detach().argmax(dim=-1)  # the first max, as the kernel
    w_pix = weights.detach().gather(1, amax.reshape(n, -1)).reshape(amax.shape)
    return -(p.square() * w_pix.unsqueeze(-1)).sum() / (n * c if normalizer is None
                                                        else normalizer)


def fused_max_square_loss_reference(logits: torch.Tensor, normalizer: float | None = None):
    """The plain version: ``-mean(softmax(logits)^2) / 2`` (the sum over
    ``normalizer`` in place of the mean)."""
    sq = torch.softmax(logits, dim=-1).square()
    return -(sq.mean() if normalizer is None else sq.sum() / normalizer) / 2.0


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.msl_fused_max_square_fwd_f32.argtypes = [p, p, ll, i, i, i, i, f, p, p, p]
    lib.msl_fused_max_square_fwd_f32.restype = i
    lib.msl_fused_max_square_bwd_f32.argtypes = [p, p, p, ll, i, i, i, i, f, p, p]
    lib.msl_fused_max_square_bwd_f32.restype = i
    return lib


def _check(logits: torch.Tensor, weights: torch.Tensor | None, what: str):
    if logits.dim() != 4:
        raise ValueError(f"{what}: logits must be 4-D NHWC, got {tuple(logits.shape)}")
    n, _, _, c = logits.shape
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"{what}: {c} classes; the kernel takes 1 to {MAX_CLASSES}")
    tensors = {"logits": logits}
    if weights is not None:
        if tuple(weights.shape) != (n, c):
            raise ValueError(f"{what}: weights have shape {tuple(weights.shape)}, expected {(n, c)}")
        tensors["weights"] = weights
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; only float32 is supported")
        if t.device != logits.device:
            raise ValueError(f"{what}: {name} is on {t.device}, logits on {logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _grid(logits: torch.Tensor) -> tuple[int, int, int, int]:
    """(pixels, H*W, C, blocks): a block per PX_PER_BLOCK pixels, so the
    partials, and with them the loss's bits, depend on the shape alone."""
    n, h, w, c = logits.shape
    pixels = n * h * w
    return pixels, h * w, c, -(-pixels // PX_PER_BLOCK)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _counted(weights):
    """The wrapper whose launch counts a kernel of this variant adds to."""
    return fused_max_square_loss if weights is None else fused_iw_max_square_loss


def _launch_forward(logits, weights, scale: float) -> torch.Tensor:
    pixels, hw, c, blocks = _grid(logits)
    partial = torch.empty(blocks, dtype=torch.float32, device=logits.device)
    out = torch.empty((), dtype=torch.float32, device=logits.device)
    lib = _library()
    with torch.cuda.device(logits.device):
        err = lib.msl_fused_max_square_fwd_f32(
            logits.data_ptr(), None if weights is None else weights.data_ptr(),
            pixels, hw, c, PX_PER_BLOCK, blocks, scale,
            partial.data_ptr(), out.data_ptr(), _stream(logits),
        )
    raise_on_error(err, lib, "fused max-square loss forward")
    _counted(weights).launches += 1
    return out


def _launch_backward(logits, weights, g, coef: float) -> torch.Tensor:
    pixels, hw, c, blocks = _grid(logits)
    g = g.to(torch.float32).contiguous()
    dx = torch.empty_like(logits)
    lib = _library()
    with torch.cuda.device(logits.device):
        err = lib.msl_fused_max_square_bwd_f32(
            logits.data_ptr(), None if weights is None else weights.data_ptr(),
            g.data_ptr(), pixels, hw, c, PX_PER_BLOCK, blocks, coef,
            dx.data_ptr(), _stream(logits),
        )
    raise_on_error(err, lib, "fused max-square loss backward")
    _counted(weights).backward_launches += 1
    return dx


class _FusedMaxSquareFn(torch.autograd.Function):
    """Both losses: ``scale * sum w_pix * sum_c p^2``, and the closed-form
    ``dx = coef * g * w_pix * (p^2 - p * s)``; ``weights`` may be None."""

    @staticmethod
    def forward(ctx, logits, weights, scale, coef):
        ctx.save_for_backward(logits, weights)
        ctx.coef = coef
        return _launch_forward(logits, weights, scale)

    @staticmethod
    def backward(ctx, g):
        logits, weights = ctx.saved_tensors
        dx = _launch_backward(logits, weights, g, ctx.coef)
        return dx, None, None, None


def fused_iw_max_square_loss(logits: torch.Tensor, weights: torch.Tensor,
                             normalizer: float | None = None) -> torch.Tensor:
    """IW max-squares from NHWC logits and detached per-image class weights:
    ``-sum(p^2 * weights[n, argmax_c p]) / (N * C)``, p = softmax over C
    (``ops.losses.iw_max_square_loss`` of the softmax). ``normalizer``
    replaces N * C: a spatial shard's sum takes the global batch's
    (``train/steps.py``). Returns a 0-d float32 tensor; ``weights`` gets no
    gradient."""
    _check(logits, weights, "fused IW max-square loss")
    if logits.device.type == "cpu":
        return fused_iw_max_square_loss_reference(logits, weights, normalizer)
    if logits.device.type != "cuda":
        raise ValueError(f"fused IW max-square loss: no kernel for device {logits.device}")
    n, _, _, c = logits.shape
    norm = n * c if normalizer is None else normalizer
    return _FusedMaxSquareFn.apply(logits, weights, -1.0 / norm, -2.0 / norm)


def fused_max_square_loss(logits: torch.Tensor, normalizer: float | None = None) -> torch.Tensor:
    """Max-squares from NHWC logits: ``-mean(softmax(logits)^2) / 2``
    (``ops.losses.max_square_loss`` of the softmax). ``normalizer``
    replaces the mean's count N*H*W*C (a spatial shard's: the global
    batch's). Returns a 0-d float32 tensor."""
    _check(logits, None, "fused max-square loss")
    if logits.device.type == "cpu":
        return fused_max_square_loss_reference(logits, normalizer)
    if logits.device.type != "cuda":
        raise ValueError(f"fused max-square loss: no kernel for device {logits.device}")
    m = logits.numel() if normalizer is None else normalizer
    return _FusedMaxSquareFn.apply(logits, None, -1.0 / (2.0 * m), -1.0 / m)


fused_iw_max_square_loss.launches = 0
fused_iw_max_square_loss.backward_launches = 0
fused_max_square_loss.launches = 0
fused_max_square_loss.backward_launches = 0
