"""Per-image class histograms and the IW class weights, on the device
(port of ``maxsquareloss_tpu/ops/histogram.py``).

The reference's IW_MaxSquareloss counts ``torch.histc(label, bins=C+1,
min=-1, max=C-1)[1:]`` per image on the CPU. For integer labels in
[-1, C-1] those bin edges put value v in bin v+1, so the device version is
one ``torch.bincount`` of ``label + 1 + n*(C+1)`` over the whole batch,
with bin 0 of each image (the ignore label) dropped. Counts are exact in
float32 up to 2^24 pixels per image.
"""

from __future__ import annotations

import torch

from maxsquareloss_torch.utils.debug import sync


def class_histogram(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, H, W) int labels in [-1, C-1] (-1 = ignore) → (N, C) float32
    counts of each class per image."""
    n = labels.shape[0]
    bins = num_classes + 1
    offset = torch.arange(n, device=labels.device).view(n, 1) * bins
    idx = labels.reshape(n, -1).long() + 1 + offset
    with sync("histogram"):  # bincount reads its output size back from the device
        counts = torch.bincount(idx.reshape(-1), minlength=n * bins)
    return counts.view(n, bins)[:, 1:].float()


def iw_class_weights(hist: torch.Tensor, ratio: float = 0.2) -> torch.Tensor:
    """``w_c = 1 / max(hist_c^ratio * (sum_c hist_c)^(1-ratio), 1)`` per
    image, detached (the reference detaches the weights). (N, C) float32."""
    hist = hist.detach().float()
    total = hist.sum(dim=-1, keepdim=True)
    denom = hist.pow(ratio) * total.pow(1.0 - ratio)
    return 1.0 / denom.clamp_min(1.0)
