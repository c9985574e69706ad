"""Plain multi-scale (+flip) evaluation and serving, through an
architecture's plain forward (``uda.Plain.forward``).

Per scale the normalized image is resized (bilinear, align_corners) to
``round(H * s), round(W * s)``, the main head runs, its logits are upsampled
(bilinear, align_corners) to the label size and turned into a softmax; the
flipped image's softmax is flipped back; the sum over scales and flips is
the score whose argmax is the prediction. With one scale and no flip the
score is the logits themselves (the argmax is the same). The logits are
upsampled and scored in float32 whatever the type of the forward. The
confusion matrix counts (label, prediction) over the pixels whose label
lies in [0, C). One image at a time, so that full-size maps fit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.uda import normalize, upsample


@torch.no_grad()
def tta_scores(sd, forward, image_uint8: torch.Tensor, scales, flip: bool, out_hw,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One uint8 (H, W, 3) image → its (C, H_out, W_out) float32 score.
    ``dtype``: the normalized image, the weights and every op up to the
    logits in that type (bfloat16: the plain bf16 computation)."""
    x = normalize(image_uint8[None]).to(dtype)
    sd = {k: v.to(dtype) for k, v in sd.items()}
    h, w = x.shape[-2:]
    heads = len(scales) * (2 if flip else 1)
    score = None
    for s in scales:
        hw = (max(1, round(h * s)), max(1, round(w * s)))
        xi = x if hw == (h, w) else F.interpolate(x, size=hw, mode="bilinear",
                                                   align_corners=True)
        views = [(xi, False)] + ([(xi.flip(-1), True)] if flip else [])
        for v, flipped in views:
            logits = upsample(forward(sd, v, aux=False)[1].float(), out_hw)
            p = logits if heads == 1 else F.softmax(logits, dim=1)
            if flipped:
                p = p.flip(-1)
            score = p if score is None else score + p
    return score[0]


def confusion_matrix(label: torch.Tensor, pred: torch.Tensor, c: int) -> torch.Tensor:
    """(C, C) int64 counts, rows the label, columns the prediction."""
    label, pred = label.reshape(-1).long(), pred.reshape(-1).long()
    valid = (label >= 0) & (label < c)
    return torch.bincount(c * label[valid] + pred[valid], minlength=c * c).reshape(c, c)
