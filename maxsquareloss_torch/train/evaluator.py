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
the one-process metrics exactly. Spans (``utils/debug.py``): ``msl.step``
around a batch, ``msl.forward`` each scale's resize and forward (a flip
rides its scale's), ``msl.tail`` each row chunk of the tail, and
``msl.sync`` each confusion matrix, whose sizes come back to the host.

Spatial partitioning (``space``, ``--sp``): every rank of a space group
holds the same images, its rows of each (``parallel/spatial.py``'s
split of the image's and the label's heights). Each scale's resized image
is split the same way: a rank's resized rows come from the global
interpolation matrix's rows over the input rows they read, fetched from
their owners. The forward is the model's spatially partitioned forward;
each head's logits are fetched over the rows that the rank's own output
rows read, upsampled to those rows only, and softmax, the TTA sum, argmax
and the confusion matrix run on them (``--eval_h_chunk`` chunks inside
them). ``evaluate`` sums the matrices over every rank, space and data
groups alike.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.metrics import Eval, confusion_matrix_update
from maxsquareloss_torch.models.deeplabv2 import eval_form, valid_logits_hw
from maxsquareloss_torch.ops.resize import input_rows, resize_bilinear_align_corners, resize_shard
from maxsquareloss_torch.parallel import ddp, spatial
from maxsquareloss_torch.parallel.spatial import SpaceGroup
from maxsquareloss_torch.train.steps import _prepare_inputs
from maxsquareloss_torch.utils.debug import span


def resolve_h_chunk(h_chunk: int, out_h: int) -> int:
    """``h_chunk < 0`` = auto: 256-row chunks whenever the label height
    exceeds 512, unchunked otherwise. ``0`` = off; positive values pass."""
    if h_chunk < 0:
        return 256 if out_h > 512 else 0
    return h_chunk


def tta_prob_rows(model, x: torch.Tensor, scales, flip: bool, out_hw,
                  space: SpaceGroup | None = None, in_h: int | None = None):
    """Run the TTA forwards and return ``prob_rows(r0, r1)``.

    One forward per scale; flip rides the same forward as a doubled batch
    (frozen BN: no coupling across the batch). The heads run their eval form
    (``deeplabv2.eval_form``), as the JAX evaluator's ``model_config(cfg,
    eval_mode=True)``, on a model built for training too. ``prob_rows`` yields the
    scale/flip-summed probabilities for output rows [r0, r1), or the raw
    logits when there is a single head (argmax is softmax-invariant).
    ``space``: ``x`` is this rank's rows of images of ``in_h`` rows, and
    ``prob_rows`` takes rows inside this rank's rows of ``out_hw``.
    """
    model = eval_form(model)
    h, w = (x.shape[1] if space is None else in_h), x.shape[2]
    n = x.shape[0]
    heads = []  # (logits, flipped, the logits' height, their first row) a head
    for s in scales:
        with span("msl.forward"):
            sh, sw = max(1, round(h * s)), max(1, round(w * s))
            if (sh, sw) == (h, w):
                img = x
            elif space is None:
                img = resize_bilinear_align_corners(x, (sh, sw))
            else:
                img = resize_shard(x, h, (sh, sw), space)
            sp_args = {} if space is None else {"space": space, "in_h": sh}
            lh, row0 = valid_logits_hw((sh, sw))[0], 0
            if flip:
                _, logits = model(torch.cat([img, img.flip(2)], dim=0), aux=False, **sp_args)
            else:
                logits = model(img, aux=False, **sp_args)[1]
            if space is not None:
                # the logit rows this rank's output rows read
                need = [input_rows(out_hw[0], lh, *o) for o in space.split(out_hw[0])]
                logits = spatial.fetch_rows(logits, space.split(lh), need, space)
                row0 = need[space.index][0]
        if flip:
            heads.append((logits[:n], False, lh, row0))
            heads.append((logits[n:], True, lh, row0))
        else:
            heads.append((logits, False, lh, row0))

    def prob_rows(r0: int, r1: int) -> torch.Tensor:
        prob = None
        for logits, flipped, lh, row0 in heads:
            sp_args = {} if space is None else {"in_h": lh, "row0": row0}
            up = resize_bilinear_align_corners(logits, out_hw, h_rows=(r0, r1), **sp_args)
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
    space: SpaceGroup | None = None,
):
    """``step(x, y) → (cm int64 (C, C), argpred int32 (N, H, W))`` for a
    uint8 (or normalized float) NHWC batch ``x`` and labels ``y`` on the
    model's device. ``h_chunk`` defaults to ``cfg.eval_h_chunk``.
    ``space``: ``step(x, y, heights=(image H, label H))`` on this rank's
    rows of each, returning the matrix of its label rows and their argmax
    (collective over the space group)."""
    n_eval = num_eval_classes or cfg.num_classes
    scales = tuple(float(s) for s in scales)
    if h_chunk is None:
        h_chunk = cfg.eval_h_chunk

    @torch.inference_mode()
    def step(x: torch.Tensor, y: torch.Tensor, heights: tuple[int, int] | None = None):
        with span("msl.step"):
            x, y = _prepare_inputs(x, y, cfg)
            if space is None:
                in_h, out_hw, (o0, o1) = None, (y.shape[1], y.shape[2]), (0, y.shape[1])
            else:
                in_h, out_hw = heights[0], (heights[1], y.shape[2])
                o0, o1 = space.own(out_hw[0])
            prob_rows = tta_prob_rows(model, x, scales, flip, out_hw, space, in_h)
            hc = resolve_h_chunk(h_chunk, out_hw[0])
            if not hc or hc >= o1 - o0:
                with span("msl.tail"):
                    argpred = prob_rows(o0, o1).argmax(dim=-1).int()
                    return confusion_matrix_update(y, argpred, n_eval), argpred
            cm = torch.zeros((n_eval, n_eval), dtype=torch.int64, device=y.device)
            parts = []
            for r0 in range(o0, o1, hc):
                with span("msl.tail"):
                    r1 = min(r0 + hc, o1)
                    arg = prob_rows(r0, r1).argmax(dim=-1).int()
                    cm += confusion_matrix_update(y[:, r0 - o0:r1 - o0], arg, n_eval)
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
    space: SpaceGroup | None = None,
) -> dict[str, float]:
    """mIoU over ``loader``'s (images, labels, names) batches (numpy or
    torch), on the model's device; with several processes over every
    rank's shard. ``space``: every rank of a space group loads the same
    batches and takes its rows of each image and label on the host, before
    the copy to the device."""
    step = make_multiscale_eval_step(cfg, model, scales, flip, space=space)
    device = _model_device(model)
    ev = Eval(cfg.num_classes)
    cm_sum = torch.zeros((cfg.num_classes,) * 2, dtype=torch.int64, device=device)
    for xs, ys, _ in loader:
        xs, ys = torch.as_tensor(xs), torch.as_tensor(ys)
        if space is None:
            cm, _ = step(xs.to(device), ys.to(device))
        else:
            heights = (xs.shape[1], ys.shape[1])
            (a, b), (c, d) = space.own(heights[0]), space.own(heights[1])
            cm, _ = step(xs[:, a:b].to(device), ys[:, c:d].to(device), heights)
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
