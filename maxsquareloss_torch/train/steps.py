"""Train and eval steps of the port (counterparts of
``maxsquareloss_tpu/train/steps.py``).

A train step is eager PyTorch: forward(s) in the compute dtype, fp32
logits → align-corners upsample →
loss(es) → ONE ``backward()`` of the summed loss → torch SGD over the 1x/10x
groups at the poly LR of the iteration before the step → refresh of the
eval kernel's packed weights. The UDA step's target loss for
``IW_maxsquare`` and ``maxsquare`` is the fused softmax + max-square kernel
on the upsampled target logits; the softmax that feeds the guidance, the
histogram and the IW weights runs under ``torch.no_grad()``, as the JAX
code's ``stop_gradient``s imply. Metrics come back as 0-d tensors on the
model's device: the step reads no value back to the host, unless
``--debug_nans`` asks it to check the loss.

Data parallelism (``parallel/``, one process per card under ``torchrun``):
each process takes its share of the global batch and the step is the
global batch's step. DDP sees the whole loss, both forwards of a UDA step
included, as one module forward (``_StepLoss``), and averages the ranks'
gradients. So that the average is the global batch's gradient, each pixel
CE is divided by its valid count over the global batch (one all-reduce of
the ranks' counts a step) and scaled by the world size; the other losses
are means over equal per-rank shares, which average right as they are.
The returned metrics are the global batch's (one all-gather a step). In
one process none of this runs: the step is the one-card step.

``--concat_batches``: the UDA step runs source and target as one forward
over a canvas batch (zero-padded at the bottom and right to the larger
crop, the pad region re-zeroed by the model's canvas masks), then slices
each batch's valid logits back out; with frozen BN it computes what the two
forwards do.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.data.palette import IMAGENET_MEAN, IMAGENET_STD, IMG_MEAN
from maxsquareloss_torch.kernels.fused_loss import (
    fused_iw_max_square_loss,
    fused_max_square_loss,
)
from maxsquareloss_torch.models.deeplabv2 import (
    DeepLabV2Config,
    make_canvas_masks,
    valid_logits_hw,
)
from maxsquareloss_torch.ops.losses import (
    IGNORE_INDEX,
    cross_entropy,
    entropy_loss,
    iw_entropy_loss,
    iw_pixel_weights,
    self_produced_guidance,
)
from maxsquareloss_torch.ops.resize import upsample_logits
from maxsquareloss_torch.optim import make_sgd, poly_lr, set_lr
from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.utils.debug import anomaly_mode


def model_config(cfg: TrainConfig) -> DeepLabV2Config:
    """The model's config from the run's: its compute dtype and remat too.
    (The JAX package's ``eval_mode``, its ASPP matmul form for eval, has no
    counterpart: ``models.deeplabv2.Classifier``.)"""
    return DeepLabV2Config(
        num_classes=cfg.num_classes,
        multi_level=cfg.multi,
        blocks=tuple(cfg.blocks),
        compute_dtype=cfg.dtype,
        remat=cfg.remat,
    )


def _prepare_inputs(x: torch.Tensor | None, y: torch.Tensor | None, cfg: TrainConfig):
    """Normalize uint8 NHWC images on their device, widen labels to int64.

    The caffe path (``numpy_transform``, the protocol default) is BGR minus
    ``IMG_MEAN``, bitwise the host pipeline's float32 result; the
    torchvision path is ``(x/255 - mean) / std``. float inputs pass
    through untouched (already normalized).
    """
    if x is not None and x.dtype == torch.uint8:
        xf = x.float()
        if cfg.numpy_transform:
            x = xf.flip(-1) - torch.from_numpy(IMG_MEAN).to(x.device)
        else:
            mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
            std = torch.from_numpy(IMAGENET_STD).to(x.device)
            x = (xf / 255.0 - mean) / std
    if y is not None and y.dtype != torch.int64:
        y = y.long()
    return x, y


class _StepLoss(nn.Module):
    """A step's whole loss as one forward: DDP expects one forward a
    backward, and a UDA step runs the model twice."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, loss_fn, *args):
        return loss_fn(self.model, *args)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the global iteration (drives the poly
    LR). A step updates the model and optimizer in place. ``ddp_loss``: the
    DDP wrapper of ``_StepLoss(model)`` when there are several processes."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    iteration: int = 0
    ddp_loss: torch.nn.Module | None = None


def make_train_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh optimizer over ``model``; with several processes, DDP over
    the step's loss (which makes every rank start from rank 0's
    parameters). Build it once per model and process."""
    wrapped = None
    if ddp.world() > 1:
        wrapped = ddp.wrap(_StepLoss(model))
        model.pack_weights()  # the parameters are rank 0's now
    return TrainState(model=model, optimizer=make_sgd(model, cfg), ddp_loss=wrapped)


def _step_loss(state: TrainState, loss_fn, *args):
    """``loss_fn(model, *args)``; under DDP through its wrapper."""
    if state.ddp_loss is None:
        return loss_fn(state.model, *args)
    return state.ddp_loss(loss_fn, *args)


def _ce_divisors(*labels: torch.Tensor | None) -> tuple:
    """The divisor of each pixel CE over ``labels`` (None: no such CE):
    ``max(global count, 1) / world`` from one all-reduce of the ranks'
    counts, so that the mean over the ranks that DDP takes is the global
    batch's CE. In one process that is the CE's own ``max(count, 1)``."""
    present = [y for y in labels if y is not None]
    counts = ddp.all_reduce_sum(torch.stack([(y != IGNORE_INDEX).sum() for y in present]))
    divisors = iter(counts.clamp_min(1).float() / ddp.world())
    return tuple(None if y is None else next(divisors) for y in labels)


def _global_metrics(metrics: dict) -> dict:
    """The global batch's metrics from every rank's, in one all-gather: the
    mean over the ranks (CEs are already scaled to the global count, the
    other terms are means over equal shares), the max of
    ``iw_pixel_w_max``."""
    ranks = ddp.all_gather(torch.stack(list(metrics.values())))
    return {k: ranks[:, i].max() if k == "iw_pixel_w_max" else ranks[:, i].mean()
            for i, k in enumerate(metrics)}


def _forward_upsampled(model, x, out_hw):
    """Forward + align-corners upsample of both heads to ``out_hw``."""
    aux, main = model(x)
    main = upsample_logits(main, out_hw)
    if aux is not None:
        aux = upsample_logits(aux, out_hw)
    return aux, main


def _concat_forward_upsampled(model, xs, out_hw_s, xt):
    """One forward over source and target on a shared canvas: each batch
    zero-padded at the bottom and right to (max H, max W), after
    normalization (a padded uint8 image would put -IMG_MEAN under the stem's
    7x7 at the valid border). Returns the upsampled (aux_s, main_s) at
    ``out_hw_s`` and (aux_t, main_t) at the target's size."""
    n = xs.shape[0]
    src_hw, tgt_hw = tuple(xs.shape[1:3]), tuple(xt.shape[1:3])
    canvas = (max(src_hw[0], tgt_hw[0]), max(src_hw[1], tgt_hw[1]))

    def to_canvas(img, hw):  # NHWC: pad W, then H, at the far side
        return F.pad(img, (0, 0, 0, canvas[1] - hw[1], 0, canvas[0] - hw[0]))

    masks = make_canvas_masks(canvas, [(n, src_hw), (xt.shape[0], tgt_hw)], xs.device)
    aux_all, main_all = model(torch.cat([to_canvas(xs, src_hw), to_canvas(xt, tgt_hw)]),
                              masks=masks)

    def heads(rows, hw, out_hw):
        vh, vw = valid_logits_hw(hw)
        return tuple(None if t is None else upsample_logits(t[rows, :vh, :vw], out_hw)
                     for t in (aux_all, main_all))

    return heads(slice(0, n), src_hw, out_hw_s), heads(slice(n, None), tgt_hw, tgt_hw)


def _source_metrics(aux, main, y, cfg: TrainConfig, divisor):
    loss = cross_entropy(main, y, divisor=divisor)
    metrics = {"loss_source": loss.detach()}
    if aux is not None:
        loss_aux = cross_entropy(aux, y, divisor=divisor)
        metrics["loss_source_aux"] = loss_aux.detach()
        loss = loss + cfg.lambda_seg * loss_aux
    return loss, metrics


@torch.no_grad()
def target_guidance(logits_main: torch.Tensor, logits_aux: torch.Tensor | None,
                    cfg: TrainConfig):
    """(the main head's softmax, the target's hard label or None) from the
    upsampled target logits: with the aux head the pseudo-label of the head
    ensemble (it feeds the IW histogram under ``--iw_hist guidance`` and the
    aux head's CE); without it, in ``hard`` mode, the main head's confident
    argmax."""
    prob_main = torch.softmax(logits_main, dim=-1)
    label = None
    if logits_aux is not None:
        label = self_produced_guidance(
            prob_main, torch.softmax(logits_aux, dim=-1), cfg.threshold,
            mask_mode=cfg.guidance_mask,
        )
    elif cfg.target_mode == "hard":
        maxp, arg = prob_main.max(dim=-1)
        label = torch.where(maxp > cfg.threshold, arg, -1)
    return prob_main, label


def target_loss_fn(logits_main: torch.Tensor, prob_main: torch.Tensor,
                   label: torch.Tensor | None, cfg: TrainConfig, divisor):
    """Mode-dispatched target loss from the upsampled target logits, their
    softmax and label (``target_guidance``). ``divisor``: the ``hard``
    CE's (``_ce_divisors``). Returns (target_loss, metrics)."""
    c = logits_main.shape[-1]
    mode = cfg.target_mode
    iw = mode in ("IW_maxsquare", "IW_entropy")
    with torch.no_grad():
        hist_label = label if cfg.iw_hist == "guidance" else None
        if iw:
            weights, pixel_w = iw_pixel_weights(prob_main, hist_label, c, cfg.ratio)
    if mode == "maxsquare":
        loss = fused_max_square_loss(logits_main)
    elif mode == "IW_maxsquare":
        loss = fused_iw_max_square_loss(logits_main, weights)
    elif mode == "entropy":
        loss = entropy_loss(torch.softmax(logits_main, dim=-1))
    elif mode == "IW_entropy":
        loss = iw_entropy_loss(torch.softmax(logits_main, dim=-1), hist_label,
                               num_classes=c, ratio=cfg.ratio)
    elif mode == "hard":
        # hard pseudo-label CE on the main head's log-probabilities
        logp = torch.log(torch.softmax(logits_main, dim=-1).clamp(1e-30, 1.0))
        valid = label != -1
        nll = -logp.gather(-1, torch.where(valid, label, 0).unsqueeze(-1)).squeeze(-1)
        loss = torch.where(valid, nll, 0.0).sum() / divisor
    else:
        raise ValueError(f"unknown target_mode {mode!r}")
    metrics = {"loss_target_raw": loss.detach()}
    if label is not None:
        metrics["guidance_valid_frac"] = (label != -1).float().mean()
    if iw:
        # the degenerate-weight canary: 1.0 is the w_c = 1 branch firing
        metrics["iw_pixel_w_max"] = pixel_w.max()
        metrics["iw_pixel_w_mean"] = pixel_w.mean()
    return loss, metrics


def _apply_update(state: TrainState, loss: torch.Tensor, cfg: TrainConfig) -> float:
    """One backward and one SGD step at the LR of ``state.iteration``
    (before the increment); refresh the packed eval weights. The LR.
    ``--debug_nans``: a loss that is not finite on any rank raises
    ``FloatingPointError`` on every rank before the update (the step's one
    read back under the flag). The gradients are zeroed, not dropped: under
    DDP they stay in its buckets."""
    if cfg.debug_nans and ddp.any_flag(not bool(torch.isfinite(loss))):
        raise FloatingPointError(f"iteration {state.iteration}: loss is not finite "
                                 f"({loss.item()} on rank {ddp.rank()})")
    lr = poly_lr(cfg.lr, state.iteration, cfg.iter_max, cfg.poly_power)
    set_lr(state.optimizer, lr)
    state.optimizer.zero_grad(set_to_none=False)
    loss.backward()
    state.optimizer.step()
    state.model.pack_weights()
    state.iteration += 1
    return lr


def _finish_metrics(metrics: dict, loss: torch.Tensor, lr: float) -> dict:
    metrics["loss"] = loss.detach()
    metrics = _global_metrics(metrics)
    metrics["lr"] = torch.full((), lr, dtype=torch.float32, device=loss.device)
    return metrics


def make_supervised_train_step(cfg: TrainConfig):
    """Source-only supervised step: ``step(state, x, y) → (state, metrics)``
    for NHWC images and (N, H, W) labels on the model's device. With
    ``--debug_nans`` the step runs in autograd's anomaly mode."""

    def loss_fn(model, x, y):
        (divisor,) = _ce_divisors(y)
        return _source_metrics(*_forward_upsampled(model, x, y.shape[-2:]), y, cfg, divisor)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        x, y = _prepare_inputs(x, y, cfg)
        with anomaly_mode(cfg.debug_nans):
            loss, metrics = _step_loss(state, loss_fn, x, y)
            lr = _apply_update(state, loss, cfg)
        return state, _finish_metrics(metrics, loss, lr)

    return step


def make_uda_train_step(cfg: TrainConfig):
    """UDA step over a (source, target) batch pair: ``step(state, xs, ys,
    xt) → (state, metrics)``. Source CE (+ ``lambda_seg`` aux CE) +
    ``lambda_target`` x target loss (+ ``lambda_target * lambda_seg`` x the
    aux head's guidance CE), one backward, one SGD step. Source and target
    run as two forwards, or as one canvas forward with
    ``--concat_batches`` (the JAX step's two branches). With
    ``--debug_nans`` the step runs in autograd's anomaly mode."""

    def loss_fn(model, xs, ys, xt):
        if cfg.concat_batches:
            src, (aux_t, main_t) = _concat_forward_upsampled(model, xs, ys.shape[-2:], xt)
        else:
            src = _forward_upsampled(model, xs, ys.shape[-2:])
            aux_t, main_t = _forward_upsampled(model, xt, (xt.shape[1], xt.shape[2]))
        prob_main, label = target_guidance(main_t, aux_t, cfg)
        src_divisor, label_divisor = _ce_divisors(ys, label)
        src_loss, metrics = _source_metrics(*src, ys, cfg, src_divisor)
        tgt_loss, tmetrics = target_loss_fn(main_t, prob_main, label, cfg, label_divisor)
        metrics.update(tmetrics)
        total = src_loss + cfg.lambda_target * tgt_loss
        if aux_t is not None and label is not None:
            # self-produced guidance: the aux head learns the hard
            # ensemble pseudo-label
            loss_aux_t = cross_entropy(aux_t, label, divisor=label_divisor)
            metrics["loss_target_aux"] = loss_aux_t.detach()
            total = total + cfg.lambda_target * cfg.lambda_seg * loss_aux_t
        metrics["loss_target"] = (cfg.lambda_target * tgt_loss).detach()
        return total, metrics

    def step(state: TrainState, xs: torch.Tensor, ys: torch.Tensor, xt: torch.Tensor):
        xs, ys = _prepare_inputs(xs, ys, cfg)
        xt, _ = _prepare_inputs(xt, None, cfg)
        with anomaly_mode(cfg.debug_nans):
            total, metrics = _step_loss(state, loss_fn, xs, ys, xt)
            lr = _apply_update(state, total, cfg)
        return state, _finish_metrics(metrics, total, lr)

    return step


def make_eval_step(cfg: TrainConfig, model, num_eval_classes: int | None = None):
    """Validation step: forward → upsample to label size → argmax → CM
    partial; the multi-scale evaluator with the single scale-1.0 head."""
    from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step

    return make_multiscale_eval_step(
        cfg, model, scales=(1.0,), flip=False, num_eval_classes=num_eval_classes
    )
