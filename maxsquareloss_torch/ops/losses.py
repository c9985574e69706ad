"""The loss family of the MaxSquareLoss reference (port of
``maxsquareloss_tpu/ops/losses.py``).

Every function takes NHWC logits or probabilities and (N, H, W) integer
labels with -1 = ignore, as the JAX package. Nothing here syncs with the
host. The fused max-square kernels (``kernels/fused_loss.py``) compute
``max_square_loss`` and ``iw_max_square_loss`` of the softmax straight
from the logits; the functions here are the plain forms the other target
modes and the tests use.

Spatial partitioning (``--sp``): a rank holds its rows of each image.
The IW weights come from each image's histogram summed over the space
group (``iw_pixel_weights(..., space=)``, one all-reduce), and the means
take ``count``, the number of terms a rank's sum divides by under the
train steps' scaling rule (``train/steps.py``), in place of their own.
"""

from __future__ import annotations

import math

import torch

from maxsquareloss_torch.ops.histogram import class_histogram, iw_class_weights
from maxsquareloss_torch.parallel import ddp

IGNORE_INDEX = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = IGNORE_INDEX,
                  divisor: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel CE with ``ignore_index``, summed over the valid pixels and
    divided by ``max(count, 1)``: ``nn.CrossEntropyLoss(ignore_index=-1)``
    where a pixel is valid, 0 (not NaN) on an all-ignored label.
    ``divisor`` replaces ``max(count, 1)``: a data-parallel step passes the
    global batch's (``train/steps.py``)."""
    valid = labels != ignore_index
    logp = torch.log_softmax(logits, dim=-1)
    safe = torch.where(valid, labels, 0).long()
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, 0.0)
    if divisor is None:
        divisor = valid.sum().clamp_min(1).to(nll.dtype)
    return nll.sum() / divisor


def soft_cross_entropy(logits: torch.Tensor, target_prob: torch.Tensor) -> torch.Tensor:
    """Soft-label CE: mean over pixels of ``-sum_c q_c log softmax_c``."""
    return -(target_prob * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def _mean(t: torch.Tensor, count: float | None) -> torch.Tensor:
    return t.mean() if count is None else t.sum() / count


def max_square_loss(prob: torch.Tensor, count: float | None = None) -> torch.Tensor:
    """``-mean(p^2) / 2`` (the reference's ignore mask never fires on
    probabilities); ``count`` replaces the mean's N*H*W*C."""
    return -_mean(prob.square(), count) / 2.0


@torch.no_grad()
def iw_pixel_weights(prob: torch.Tensor, label: torch.Tensor | None,
                     num_classes: int, ratio: float, space=None):
    """Detached IW weights: (per-image class weights (N, C), per-pixel
    weights (N, H, W) gathered at the first argmax of ``prob``). The
    histogram counts ``label`` where given, else the argmax; with a space
    group (``parallel/spatial.py``) each rank counts its rows and the
    counts are summed over the group, so the weights are the whole
    image's."""
    n = prob.shape[0]
    argpred = prob.argmax(dim=-1)
    hist = class_histogram(argpred if label is None else label, num_classes)
    if space is not None:
        hist = ddp.all_reduce_sum(hist, space.group)
    w = iw_class_weights(hist, ratio)
    pixel_w = w.gather(1, argpred.reshape(n, -1)).reshape(argpred.shape)
    return w, pixel_w


def iw_max_square_loss(prob: torch.Tensor, label: torch.Tensor | None = None,
                       num_classes: int | None = None, ratio: float = 0.2) -> torch.Tensor:
    """Image-wise class-balanced max-squares: ``-sum(p^2 * w_pix) / (N*C)``."""
    n, c = prob.shape[0], num_classes or prob.shape[-1]
    _, pixel_w = iw_pixel_weights(prob, label, c, ratio)
    return -(prob.square() * pixel_w.unsqueeze(-1)).sum() / (n * c)


def _entropy(prob: torch.Tensor) -> torch.Tensor:
    return -(prob * torch.log(prob + 1e-30)).sum(dim=-1)


def entropy_loss(prob: torch.Tensor, count: float | None = None) -> torch.Tensor:
    """Mean per-pixel Shannon entropy over log(C) (the normalised entropy);
    ``count`` replaces the mean's pixel count."""
    return _mean(_entropy(prob), count) / math.log(prob.shape[-1])


def iw_entropy_loss(prob: torch.Tensor, label: torch.Tensor | None = None,
                    num_classes: int | None = None, ratio: float = 0.2,
                    count: float | None = None, space=None) -> torch.Tensor:
    """Image-wise class-balanced entropy: mean of ``entropy * w_pix`` over
    log(C); ``count`` and ``space`` as in ``entropy_loss`` and
    ``iw_pixel_weights``."""
    c = num_classes or prob.shape[-1]
    _, pixel_w = iw_pixel_weights(prob, label, c, ratio, space)
    return _mean(_entropy(prob) * pixel_w, count) / math.log(c)


@torch.no_grad()
def self_produced_guidance(prob_main: torch.Tensor, prob_aux: torch.Tensor,
                           threshold: float = 0.95,
                           ignore_index: int = IGNORE_INDEX,
                           mask_mode: str = "ensemble") -> torch.Tensor:
    """Multi-level pseudo-labels: the argmax of ``(P_main + P_aux) / 2``
    where the confidence mask passes, else ``ignore_index``; detached.
    ``mask_mode``: ``"ensemble"`` (max ensemble probability > threshold) or
    ``"per_head_or"`` (either head's own max probability > threshold).
    Returns (N, H, W) int64."""
    ens = (prob_main + prob_aux) / 2.0
    if mask_mode == "ensemble":
        confident = ens.amax(dim=-1) > threshold
    elif mask_mode == "per_head_or":
        confident = (prob_main.amax(dim=-1) > threshold) | (prob_aux.amax(dim=-1) > threshold)
    else:
        raise ValueError(f"unknown guidance mask_mode {mask_mode!r}")
    return torch.where(confident, ens.argmax(dim=-1), ignore_index)
