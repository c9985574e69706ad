"""The comparison that decides ``correct``.

Training (the first checked steps of the window's own step object):

- ``loss_gap``: the largest over the steps of |L_program - L_ref| / |L_ref|;
- ``grad_gap``: the first gradient as the optimizer got it, by leaf: the
  worst |norm_program - norm_ref| over max(norm_ref, the median leaf's
  norm_ref);
- ``change_gap``: each leaf's change over the checked steps, by the same
  measure, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (a leaf below that moves by round-off
  and weight decay alone); ``change_gap_median``: the median of those
  leaves' gaps instead of the worst (steady from seed to seed where one
  leaf's gap swings).

Evaluation and serving (a sample of the window's answers, drawn from the
seed): the margin by which the reference's score of the class the program
chose lies below the reference's best score (the mean of the test-time
views' softmax; with one view the logits over the image's largest
|logit|), its mean over the pixels (``score_gap_mean``) and, for
evaluation, that mean over the mean margin of the plain bf16 computation
(the reference with the image, the weights and every op in bf16) of the
same images (``score_gap_vs_bf16``), and exact counts for the confusion
matrices.
"""

from __future__ import annotations

import statistics

import torch


def leaf_gaps(program: dict, ref: dict, keys=None) -> list[float]:
    """Each leaf's |norm gap| over max(its reference norm, the median leaf's)."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in keys)
    return [abs(program[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def train_gaps(program: dict, ref: dict) -> dict[str, float]:
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(program["losses"], ref["losses"], strict=True))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = [k for k in g if g[k] >= 1e-3 * med]
    changes = leaf_gaps(program["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": loss_gap,
            "grad_gap": max(leaf_gaps(program["grad_norms"], g)),
            "change_gap": max(changes),
            "change_gap_median": statistics.median(changes),
            "leaves_left_out": len(g) - len(moving)}


def score_stats(score: torch.Tensor, pred: torch.Tensor, views: int) -> dict[str, float]:
    """``score`` (C, H, W) of the reference, ``pred`` (H, W) the program's
    classes, margins in units of the score (a mean probability; with one
    view, of the image's largest |logit|): ``score_gap``, the widest margin
    as set out above, and ``score_gap_mean``, the mean margin over the
    pixels. A class out of range reads inf."""
    c = score.shape[0]
    pred = pred.to(score.device).long()
    if pred.shape != score.shape[1:] or int(pred.min()) < 0 or int(pred.max()) >= c:
        return dict.fromkeys(STATS, float("inf"))
    chosen = score.gather(0, pred[None])[0]
    scale = views if views > 1 else score.abs().max().clamp_min(1e-30)
    margin = (score.max(0).values - chosen) / scale
    return {"score_gap": float(margin.max()), "score_gap_mean": float(margin.double().mean())}


STATS = ("score_gap", "score_gap_mean")


def merge_stats(a: dict | None, b: dict) -> dict:
    """Two samples' ``score_stats`` as one: the widest of the widest, the
    mean of the means (equal pixel counts)."""
    if a is None:
        return dict(b, n=1)
    n = a["n"]
    out = {k: max(a[k], b[k]) if k == "score_gap" else (a[k] * n + b[k]) / (n + 1)
           for k in STATS}
    return dict(out, n=n + 1)
