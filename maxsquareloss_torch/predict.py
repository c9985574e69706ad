"""The serving core: (model, uint8 NHWC batch) → int32 trainIds (port of
``tools/predict.py`` ``make_predict_fn``).

Multi-scale (+flip) probability-averaged argmax with the evaluator's TTA
heads (``train/evaluator.tta_prob_rows``) and the same row-chunked tail
(``cfg.eval_h_chunk``; auto = 256-row chunks when the output is taller
than 512 rows). The file-writing CLI comes with the CLIs. ``space``
(``--sp``): the function takes this rank's rows of the images and returns
its rows of the trainIds (``train/evaluator.py``'s spatial path). Spans:
``msl.step`` around a call, the evaluator's ``msl.forward`` and
``msl.tail`` inside it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.parallel.spatial import SpaceGroup
from maxsquareloss_torch.train.evaluator import resolve_h_chunk, tta_prob_rows
from maxsquareloss_torch.train.steps import _prepare_inputs
from maxsquareloss_torch.utils.debug import span


def make_predict_fn(
    cfg: TrainConfig,
    model,
    scales: Sequence[float],
    flip: bool,
    out_hw: tuple[int, int],
    space: SpaceGroup | None = None,
):
    """``fn(x) → (N, H_out, W_out) int32`` for a uint8 (or normalized
    float) NHWC batch on the model's device, under inference mode.
    ``space``: ``fn(x, in_h)`` on this rank's rows of images of ``in_h``
    rows returns its rows of the output (collective over the group)."""
    return torch.inference_mode()(predict_core(cfg, model, scales, flip, out_hw, space))


def predict_core(cfg: TrainConfig, model, scales: Sequence[float], flip: bool,
                 out_hw: tuple[int, int], space: SpaceGroup | None = None):
    """``make_predict_fn``'s function without inference mode: the graph
    ``tools/export_inference.py`` traces (under ``torch.no_grad``)."""
    scales = tuple(float(s) for s in scales)
    hc = resolve_h_chunk(cfg.eval_h_chunk, out_hw[0])
    o0, o1 = (0, out_hw[0]) if space is None else space.own(out_hw[0])

    def fn(x: torch.Tensor, in_h: int | None = None) -> torch.Tensor:
        with span("msl.step"):
            x, _ = _prepare_inputs(x, None, cfg)
            prob_rows = tta_prob_rows(model, x, scales, flip, out_hw, space, in_h)

            def arg_rows(r0, r1):
                with span("msl.tail"):
                    return prob_rows(r0, r1).argmax(dim=-1).int()

            if not hc or hc >= o1 - o0:
                return arg_rows(o0, o1)
            return torch.cat([arg_rows(r0, min(r0 + hc, o1)) for r0 in range(o0, o1, hc)],
                             dim=1)

    return fn
