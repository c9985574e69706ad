"""align_corners=True bilinear resize of NHWC tensors (port of
``maxsquareloss_tpu/ops/resize.py``).

The separable interpolation is two small dense matmuls, ``out = W_h @ x @
W_w.T``, as in the JAX package: a block of output rows is then just a row
slice of ``W_h``, so the ``h_rows`` streaming of the eval tail stays exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """Dense (out_size, in_size) align-corners linear interpolation matrix."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    if out_size == 1:
        # align_corners with a single output sample reads the first input
        # pixel (torch defines scale=0 -> src=0)
        w[0, 0] = 1.0
        return w
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    w[rows, lo] = 1.0 - frac
    w[rows, lo + 1] = frac
    return w


def interp_matrix(
    out_size: int, in_size: int, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix_np(out_size, in_size)).to(
        device=device, dtype=dtype
    )


def resize_bilinear_align_corners(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    h_rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Bilinear align_corners=True resize of (N, H, W, C) tensors.

    ``h_rows=(r0, r1)`` produces only output rows [r0, r1) of the full
    (H_out, W_out) result, exactly (the H interpolation is a matmul, so a
    row block is its row slice).
    """
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    if (h_in, w_in) == (h_out, w_out) and h_rows is None:
        return x
    dtype = x.dtype if x.is_floating_point() else torch.float32
    wh = interp_matrix(h_out, h_in, dtype, x.device)  # (Ho, Hi)
    if h_rows is not None:
        wh = wh[int(h_rows[0]) : int(h_rows[1])]
    ww = interp_matrix(w_out, w_in, dtype, x.device)  # (Wo, Wi)
    n, c = x.shape[0], x.shape[-1]
    # two matmuls with contiguous NHWC results (the fused loss kernels and
    # the last-dim softmaxes read them as such)
    y = torch.matmul(wh, x.to(dtype).reshape(n, h_in, w_in * c))  # (N, Ho, Wi*C)
    return torch.matmul(ww, y.view(n, -1, w_in, c))                # (N, Ho, Wo, C)


def upsample_logits(logits: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Upsample NHWC logits to label resolution (align_corners=True)."""
    return resize_bilinear_align_corners(logits, out_hw)
