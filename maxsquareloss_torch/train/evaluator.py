"""Evaluation: single- and multi-scale (+flip) inference → mIoU (port of
``maxsquareloss_tpu/train/evaluator.py``).

Per scale, resize the input (align-corners bilinear), forward, upsample the
main-head logits to label resolution, softmax; average probabilities over
scales (and the horizontal flip); argmax → confusion matrix on the device.
The upsample→softmax→argmax→CM tail can stream over output-row blocks
(exact: row-local interpolation) so full-resolution labels never
materialize the (N, H, W, C) probability tensor. With several processes
each evaluates its shard (padded with all-ignore samples) and ``evaluate``
sums the ranks' confusion matrices before any metric, so the metrics are
the one-process metrics exactly.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.metrics import Eval, confusion_matrix_update
from maxsquareloss_torch.ops.resize import resize_bilinear_align_corners
from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.train.steps import _prepare_inputs


def resolve_h_chunk(h_chunk: int, out_h: int) -> int:
    """``h_chunk < 0`` = auto: 256-row chunks whenever the label height
    exceeds 512, unchunked otherwise. ``0`` = off; positive values pass."""
    if h_chunk < 0:
        return 256 if out_h > 512 else 0
    return h_chunk


def tta_prob_rows(model, x: torch.Tensor, scales, flip: bool, out_hw):
    """Run the TTA forwards and return ``prob_rows(r0, r1)``.

    One forward per scale; flip rides the same forward as a doubled batch
    (frozen BN: no coupling across the batch). ``prob_rows`` yields the
    scale/flip-summed probabilities for output rows [r0, r1), or the raw
    logits when there is a single head (argmax is softmax-invariant).
    """
    h, w = x.shape[1], x.shape[2]
    n = x.shape[0]
    heads = []  # (logits, flipped) pairs, probability-summed below
    for s in scales:
        sh, sw = max(1, round(h * s)), max(1, round(w * s))
        img = x if (sh, sw) == (h, w) else resize_bilinear_align_corners(x, (sh, sw))
        if flip:
            _, both = model(torch.cat([img, img.flip(2)], dim=0), aux=False)
            heads.append((both[:n], False))
            heads.append((both[n:], True))
        else:
            heads.append((model(img, aux=False)[1], False))

    def prob_rows(r0: int, r1: int) -> torch.Tensor:
        prob = None
        for logits, flipped in heads:
            up = resize_bilinear_align_corners(logits, out_hw, h_rows=(r0, r1))
            p = up if len(heads) == 1 else torch.softmax(up, dim=-1)
            if flipped:
                p = p.flip(2)
            prob = p if prob is None else prob + p
        return prob

    return prob_rows


def make_multiscale_eval_step(
    cfg: TrainConfig,
    model,
    scales: Sequence[float] = (1.0,),
    flip: bool = False,
    num_eval_classes: int | None = None,
    h_chunk: int | None = None,
):
    """``step(x, y) → (cm int64 (C, C), argpred int32 (N, H, W))`` for a
    uint8 (or normalized float) NHWC batch ``x`` and labels ``y`` on the
    model's device. ``h_chunk`` defaults to ``cfg.eval_h_chunk``."""
    n_eval = num_eval_classes or cfg.num_classes
    scales = tuple(float(s) for s in scales)
    if h_chunk is None:
        h_chunk = cfg.eval_h_chunk

    @torch.inference_mode()
    def step(x: torch.Tensor, y: torch.Tensor):
        x, y = _prepare_inputs(x, y, cfg)
        out_hw = (y.shape[1], y.shape[2])
        prob_rows = tta_prob_rows(model, x, scales, flip, out_hw)
        hc = resolve_h_chunk(h_chunk, out_hw[0])
        if not hc or hc >= out_hw[0]:
            argpred = prob_rows(0, out_hw[0]).argmax(dim=-1).int()
            return confusion_matrix_update(y, argpred, n_eval), argpred
        cm = torch.zeros((n_eval, n_eval), dtype=torch.int64, device=y.device)
        parts = []
        for r0 in range(0, out_hw[0], hc):
            r1 = min(r0 + hc, out_hw[0])
            arg = prob_rows(r0, r1).argmax(dim=-1).int()
            cm += confusion_matrix_update(y[:, r0:r1], arg, n_eval)
            parts.append(arg)
        return cm, torch.cat(parts, dim=1)

    return step


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def evaluate(
    model,
    cfg: TrainConfig,
    loader: Iterable,
    scales: Sequence[float] = (1.0,),
    flip: bool = False,
    synthia_protocol: bool = False,
) -> dict[str, float]:
    """mIoU over ``loader``'s (images, labels, names) batches (numpy or
    torch), on the model's device; with several processes over every
    rank's shard."""
    step = make_multiscale_eval_step(cfg, model, scales, flip)
    device = _model_device(model)
    ev = Eval(cfg.num_classes)
    cm_sum = torch.zeros((cfg.num_classes,) * 2, dtype=torch.int64, device=device)
    for xs, ys, _ in loader:
        cm, _ = step(torch.as_tensor(xs).to(device), torch.as_tensor(ys).to(device))
        cm_sum += cm
    ev.add_confusion_matrix(ddp.all_reduce_sum(cm_sum))
    out = {
        "PA": ev.Pixel_Accuracy(),
        "MPA": ev.Mean_Pixel_Accuracy(),
        "MIoU": ev.Mean_Intersection_over_Union(),
        "FWIoU": ev.Frequency_Weighted_Intersection_over_Union(),
    }
    if synthia_protocol:
        out["MIoU_16"] = ev.Mean_Intersection_over_Union_16()
        out["MIoU_13"] = ev.Mean_Intersection_over_Union_13()
    out["_eval"] = ev  # caller can print the per-class table
    return out
