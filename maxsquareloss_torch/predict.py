"""The serving core: (model, uint8 NHWC batch) → int32 trainIds (port of
``tools/predict.py`` ``make_predict_fn``).

Multi-scale (+flip) probability-averaged argmax with the evaluator's TTA
heads (``train/evaluator.tta_prob_rows``) and the same row-chunked tail
(``cfg.eval_h_chunk``; auto = 256-row chunks when the output is taller
than 512 rows). The file-writing CLI comes with the CLIs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.train.evaluator import resolve_h_chunk, tta_prob_rows
from maxsquareloss_torch.train.steps import _prepare_inputs


def make_predict_fn(
    cfg: TrainConfig,
    model,
    scales: Sequence[float],
    flip: bool,
    out_hw: tuple[int, int],
):
    """``fn(x) → (N, H_out, W_out) int32`` for a uint8 (or normalized
    float) NHWC batch on the model's device."""
    scales = tuple(float(s) for s in scales)
    hc = resolve_h_chunk(cfg.eval_h_chunk, out_hw[0])

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        x, _ = _prepare_inputs(x, None, cfg)
        prob_rows = tta_prob_rows(model, x, scales, flip, out_hw)

        def arg_rows(r0, r1):
            return prob_rows(r0, r1).argmax(dim=-1).int()

        if not hc or hc >= out_hw[0]:
            return arg_rows(0, out_hw[0])
        return torch.cat(
            [arg_rows(r0, min(r0 + hc, out_hw[0])) for r0 in range(0, out_hw[0], hc)],
            dim=1,
        )

    return fn
