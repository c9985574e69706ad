"""align_corners=True bilinear resize of NHWC tensors (port of
``maxsquareloss_tpu/ops/resize.py``).

The separable interpolation is two small dense matmuls, ``out = W_h @ x @
W_w.T``, as in the JAX package: a block of output rows is then just a row
slice of ``W_h``, so the ``h_rows`` streaming of the eval tail stays exact.
A spatial shard (``--sp``) holds a window of the input's rows: ``in_h``
and ``row0`` say which, ``input_rows`` which window a block of output rows
reads, and the product takes those columns of the global ``W_h``;
``resize_shard`` fetches that window from the rows' owners (with grad in
training: the fetch carries the gradient back).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from maxsquareloss_torch.parallel import spatial
from maxsquareloss_torch.utils.debug import sync


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
    """The matrix on ``device``: a copy from pageable host memory, which
    waits for the stream (``msl.sync``)."""
    with sync("interp_matrix"):
        return torch.from_numpy(_interp_matrix_np(out_size, in_size)).to(
            device=device, dtype=dtype
        )


def input_rows(out_size: int, in_size: int, r0: int, r1: int) -> tuple[int, int]:
    """The input rows [c0, c1) that output rows [r0, r1) of an align-corners
    resize read (the nonzero columns of those rows of the matrix); (0, 0)
    for no rows."""
    if r1 <= r0:
        return (0, 0)
    cols = np.flatnonzero(_interp_matrix_np(out_size, in_size)[r0:r1].any(axis=0))
    return int(cols[0]), int(cols[-1]) + 1


def resize_bilinear_align_corners(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    h_rows: tuple[int, int] | None = None,
    in_h: int | None = None,
    row0: int = 0,
) -> torch.Tensor:
    """Bilinear align_corners=True resize of (N, H, W, C) tensors.

    ``h_rows=(r0, r1)`` produces only output rows [r0, r1) of the full
    (H_out, W_out) result, exactly (the H interpolation is a matmul, so a
    row block is its row slice). ``in_h``: ``x`` holds rows [row0, row0 +
    x.shape[1]) of an input of ``in_h`` rows (a spatial shard's window,
    which must cover ``input_rows`` of the output rows); the product then
    takes those columns of the global matrix.
    """
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    if (h_in, w_in) == (h_out, w_out) and h_rows is None and in_h is None:
        return x
    dtype = x.dtype if x.is_floating_point() else torch.float32
    wh = interp_matrix(h_out, h_in if in_h is None else in_h, dtype, x.device)  # (Ho, Hi)
    if h_rows is not None:
        wh = wh[int(h_rows[0]) : int(h_rows[1])]
    if in_h is not None:
        wh = wh[:, row0: row0 + h_in]
    ww = interp_matrix(w_out, w_in, dtype, x.device)  # (Wo, Wi)
    n, c = x.shape[0], x.shape[-1]
    # two matmuls with contiguous NHWC results (the fused loss kernels and
    # the last-dim softmaxes read them as such)
    y = torch.matmul(wh, x.to(dtype).reshape(n, h_in, w_in * c))  # (N, Ho, Wi*C)
    return torch.matmul(ww, y.view(n, -1, w_in, c))                # (N, Ho, Wo, C)


def upsample_logits(logits: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Upsample NHWC logits to label resolution (align_corners=True)."""
    return resize_bilinear_align_corners(logits, out_hw)


def resize_shard(x: torch.Tensor, in_h: int, out_hw: tuple[int, int], space,
                 own: list[tuple[int, int]] | None = None) -> torch.Tensor:
    """This rank's rows of the align-corners resize to ``out_hw`` of a map of
    ``in_h`` rows split over ``space`` (``x``: its rows; ``own``: every
    rank's rows when the map is not split by ownership, as a canvas's rows
    clipped to one batch's): the global matrix's rows over the input rows
    they read, fetched from their owners (``spatial.fetch_rows``).
    Collective over the space group."""
    need = [input_rows(out_hw[0], in_h, *o) for o in space.split(out_hw[0])]
    win = spatial.fetch_rows(x, own or space.split(in_h), need, space)
    return resize_bilinear_align_corners(win, out_hw, h_rows=space.own(out_hw[0]), in_h=in_h,
                                         row0=need[space.index][0])
