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

Spatial partitioning (``--sp``, ``parallel/spatial.py``): every rank of a
space group gets its data group's images and takes its rows of them and of
the labels (``--sp`` must divide each height, so every rank's share of
the labels is equal). The model runs its spatially partitioned forward
inside ``spatial.training``, each head's logits are upsampled to the
rank's label rows from the rows they read (``resize_shard``), the
guidance is per pixel, and the IW histograms are summed over the space
group. **One scaling rule for every loss on every rank:** this rank's sum
of the global loss's terms times the world size over the global
normalizer (the CEs' valid counts, the pixel counts of the means, N*C of
the IW loss, N*H*W*C of max-squares), so that the mean over the world is
the global batch's loss and gradient; the data-parallel forms above are
its case sp = 1. The gradients are averaged over the world in one
all-reduce after the backward, not by DDP (``parallel/ddp.py``), after the
token chain has run every exchange's backward in order
(``spatial.join``).

``--concat_batches``: the UDA step runs source and target as one forward
over a canvas batch (zero-padded at the bottom and right to the larger
crop, the pad region re-zeroed by the model's canvas masks), then slices
each batch's valid logits back out; with frozen BN it computes what the two
forwards do. Under ``--sp`` the canvas's rows split like any map: each
rank pads its rows of each batch, and each batch's valid logits are the
canvas logits' rows clipped to that batch's height, which ``resize_shard``
fetches from their owners (a rank whose canvas rows of a batch are all
padding gives none, but joins the exchange).
"""

from __future__ import annotations

import dataclasses
import functools

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
from maxsquareloss_torch.ops.resize import resize_shard, upsample_logits
from maxsquareloss_torch.optim import make_sgd, poly_lr, set_lr
from maxsquareloss_torch.parallel import ddp, spatial
from maxsquareloss_torch.parallel.spatial import SpaceGroup
from maxsquareloss_torch.utils.debug import anomaly_mode


def model_config(cfg: TrainConfig, eval_mode: bool = False) -> DeepLabV2Config:
    """The model's config from the run's: its compute dtype and remat too.
    ``eval_mode`` turns on the forward-only form of the ASPP heads
    (``aspp_matmul``), as in the JAX package: models built for evaluation,
    prediction, calibration and the export take it; the train steps run
    the training form."""
    return DeepLabV2Config(
        num_classes=cfg.num_classes,
        multi_level=cfg.multi,
        blocks=tuple(cfg.blocks),
        compute_dtype=cfg.dtype,
        remat=cfg.remat,
        aspp_matmul=eval_mode,
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
    DDP wrapper of ``_StepLoss(model)`` when there are several processes;
    ``average_grads``: under ``--sp`` (no wrapper), average the gradients
    over the world after each backward."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    iteration: int = 0
    ddp_loss: torch.nn.Module | None = None
    average_grads: bool = False


def make_train_state(model: torch.nn.Module, cfg: TrainConfig,
                     space: SpaceGroup | None = None) -> TrainState:
    """A fresh optimizer over ``model``; with several processes, DDP over
    the step's loss (which makes every rank start from rank 0's
    parameters), or under ``--sp`` (``space``, by default
    ``spatial.space_group(cfg.sp)``) rank 0's parameters broadcast and the
    gradients averaged after each backward. Build it once per model and
    process. An int8 model (``models/quantize.py``) raises: int8 is for
    evaluation and serving."""
    if getattr(model, "quantized", False):
        raise ValueError("an int8 model does not train: --quantize int8 is for evaluation "
                         "and serving, and training keeps the float32 weights")
    space = space or spatial.space_group(cfg.sp)
    wrapped = None
    if ddp.world() > 1:
        if space is None:
            wrapped = ddp.wrap(_StepLoss(model))
        else:
            ddp.broadcast_module(model)
        model.pack_weights()  # the parameters are rank 0's now
    return TrainState(model=model, optimizer=make_sgd(model, cfg), ddp_loss=wrapped,
                      average_grads=space is not None)


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


def _forward_upsampled(model, x, out_hw, space: SpaceGroup | None = None,
                       in_h: int | None = None):
    """Forward + align-corners upsample of both heads to ``out_hw``. With
    ``space``: ``x`` is this rank's rows of images of ``in_h`` rows, and
    the result its rows of ``out_hw``."""
    if space is None:
        aux, main = model(x)
        up = functools.partial(upsample_logits, out_hw=out_hw)
    else:
        aux, main = model(x, space=space, in_h=in_h)
        up = functools.partial(resize_shard, in_h=valid_logits_hw((in_h, x.shape[2]))[0],
                               out_hw=out_hw, space=space)
    main = up(main)
    if aux is not None:
        aux = up(aux)
    return aux, main


def _own_rows(space: SpaceGroup | None, *ts: torch.Tensor) -> tuple:
    """Each NHWC image or (N, H, W) label batch as this rank's rows of it
    (all of it without ``space``); ``--sp`` must divide each height, so
    that the ranks' shares are equal."""
    if space is None:
        return ts
    for t in ts:
        if t.shape[1] % space.sp:
            raise ValueError(f"--sp {space.sp} must divide the image height: a batch of "
                             f"height {t.shape[1]}")
    return tuple(t[:, slice(*space.own(t.shape[1]))] for t in ts)


def _canvas(src_hw, tgt_hw) -> tuple[int, int]:
    return max(src_hw[0], tgt_hw[0]), max(src_hw[1], tgt_hw[1])


def _canvas_rows(space: SpaceGroup, canvas_h: int, *ts: torch.Tensor) -> tuple:
    """Each NHWC batch as its rows inside this rank's rows of the canvas
    (none where they are all padding)."""
    o0, o1 = space.own(canvas_h)
    return tuple(t[:, min(o0, t.shape[1]):min(o1, t.shape[1])] for t in ts)


def _concat_forward_upsampled(model, xs, out_hw_s, xt, hws=None,
                              space: SpaceGroup | None = None):
    """One forward over source and target on a shared canvas: each batch
    zero-padded at the bottom and right to (max H, max W), after
    normalization (a padded uint8 image would put -IMG_MEAN under the stem's
    7x7 at the valid border). Returns the upsampled (aux_s, main_s) at
    ``out_hw_s`` and (aux_t, main_t) at the target's size. ``space``:
    ``xs`` and ``xt`` are this rank's rows of the canvas (``_canvas_rows``)
    of batches of (H, W) ``hws``, and the results its rows of each."""
    n = xs.shape[0]
    src_hw, tgt_hw = hws or (tuple(xs.shape[1:3]), tuple(xt.shape[1:3]))
    canvas = _canvas(src_hw, tgt_hw)
    rows = canvas[0] if space is None else space.own(canvas[0])[1] - space.own(canvas[0])[0]

    def to_canvas(img):  # NHWC: pad W, then H, at the far side
        return F.pad(img, (0, 0, 0, canvas[1] - img.shape[2], 0, rows - img.shape[1]))

    masks = make_canvas_masks(canvas, [(n, src_hw), (xt.shape[0], tgt_hw)], xs.device)
    batch = torch.cat([to_canvas(xs), to_canvas(xt)])
    if space is None:
        aux_all, main_all = model(batch, masks=masks)
    else:
        aux_all, main_all = model(batch, masks=masks, space=space, in_h=canvas[0])

    def heads(images, hw, out_hw):
        vh, vw = valid_logits_hw(hw)
        if space is None:
            return tuple(None if t is None else upsample_logits(t[images, :vh, :vw], out_hw)
                         for t in (aux_all, main_all))
        # every rank's canvas logit rows clipped to this batch's valid rows
        own = [(min(a, vh), min(b, vh)) for a, b in space.split(valid_logits_hw(canvas)[0])]
        mine = own[space.index][1] - own[space.index][0]
        return tuple(None if t is None else resize_shard(t[images, :mine, :vw], vh, out_hw, space,
                                                         own)
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
                   label: torch.Tensor | None, cfg: TrainConfig, divisor,
                   space: SpaceGroup | None = None, out_h: int | None = None):
    """Mode-dispatched target loss from the upsampled target logits, their
    softmax and label (``target_guidance``). ``divisor``: the ``hard``
    CE's (``_ce_divisors``). ``space``: the logits are this rank's rows of
    target maps of ``out_h`` rows; each loss divides its sum by the global
    normalizer over the world (the module docstring). Returns
    (target_loss, metrics)."""
    n, _, w, c = logits_main.shape
    mode = cfg.target_mode
    iw = mode in ("IW_maxsquare", "IW_entropy")
    images = pixels = None  # the global batch's counts over the world
    if space is not None:
        images, pixels = n / space.sp, n * out_h * w / space.sp
    with torch.no_grad():
        hist_label = label if cfg.iw_hist == "guidance" else None
        if iw:
            weights, pixel_w = iw_pixel_weights(prob_main, hist_label, c, cfg.ratio, space)
    if mode == "maxsquare":
        loss = fused_max_square_loss(logits_main, None if pixels is None else pixels * c)
    elif mode == "IW_maxsquare":
        loss = fused_iw_max_square_loss(logits_main, weights,
                                        None if images is None else images * c)
    elif mode == "entropy":
        loss = entropy_loss(torch.softmax(logits_main, dim=-1), pixels)
    elif mode == "IW_entropy":
        loss = iw_entropy_loss(torch.softmax(logits_main, dim=-1), hist_label,
                               num_classes=c, ratio=cfg.ratio, count=pixels, space=space)
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
    if state.average_grads:
        ddp.average_gradients([p for p in state.model.parameters() if p.requires_grad])
    state.optimizer.step()
    state.model.pack_weights()
    state.iteration += 1
    return lr


def _finish_metrics(metrics: dict, loss: torch.Tensor, lr: float) -> dict:
    metrics["loss"] = loss.detach()
    metrics = _global_metrics(metrics)
    metrics["lr"] = torch.full((), lr, dtype=torch.float32, device=loss.device)
    return metrics


def make_supervised_train_step(cfg: TrainConfig, space: SpaceGroup | None = None):
    """Source-only supervised step: ``step(state, x, y) → (state, metrics)``
    for NHWC images and (N, H, W) labels on the model's device. ``space``
    (default ``spatial.space_group(cfg.sp)``): ``x`` and ``y`` are the
    data group's whole batch, and the step takes this rank's rows. With
    ``--debug_nans`` the step runs in autograd's anomaly mode."""
    space = space or spatial.space_group(cfg.sp)

    def loss_fn(model, x, y, in_h, out_hw):
        (divisor,) = _ce_divisors(y)
        out = _source_metrics(*_forward_upsampled(model, x, out_hw, space, in_h), y, cfg,
                              divisor)
        return spatial.join(out[0], space), out[1]

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        in_h, out_hw = x.shape[1], tuple(y.shape[-2:])
        x, y = _own_rows(space, x, y)
        x, y = _prepare_inputs(x, y, cfg)
        with anomaly_mode(cfg.debug_nans), spatial.training(space):
            loss, metrics = _step_loss(state, loss_fn, x, y, in_h, out_hw)
            lr = _apply_update(state, loss, cfg)
        return state, _finish_metrics(metrics, loss, lr)

    return step


def make_uda_train_step(cfg: TrainConfig, space: SpaceGroup | None = None):
    """UDA step over a (source, target) batch pair: ``step(state, xs, ys,
    xt) → (state, metrics)``. Source CE (+ ``lambda_seg`` aux CE) +
    ``lambda_target`` x target loss (+ ``lambda_target * lambda_seg`` x the
    aux head's guidance CE), one backward, one SGD step. Source and target
    run as two forwards, or as one canvas forward with
    ``--concat_batches`` (the JAX step's two branches). ``space`` (default
    ``spatial.space_group(cfg.sp)``): the batches are the data group's, and
    the step takes this rank's rows (of the canvas, with
    ``--concat_batches``). With ``--debug_nans`` the step runs in
    autograd's anomaly mode."""
    space = space or spatial.space_group(cfg.sp)

    def loss_fn(model, xs, ys, xt, heights):
        src_hw, label_hw, tgt_hw = heights
        if cfg.concat_batches:
            src, (aux_t, main_t) = _concat_forward_upsampled(model, xs, label_hw, xt,
                                                             (src_hw, tgt_hw), space)
        else:
            src = _forward_upsampled(model, xs, label_hw, space, src_hw[0])
            aux_t, main_t = _forward_upsampled(model, xt, tgt_hw, space, tgt_hw[0])
        prob_main, label = target_guidance(main_t, aux_t, cfg)
        src_divisor, label_divisor = _ce_divisors(ys, label)
        src_loss, metrics = _source_metrics(*src, ys, cfg, src_divisor)
        tgt_loss, tmetrics = target_loss_fn(main_t, prob_main, label, cfg, label_divisor,
                                            space, tgt_hw[0])
        metrics.update(tmetrics)
        total = src_loss + cfg.lambda_target * tgt_loss
        if aux_t is not None and label is not None:
            # self-produced guidance: the aux head learns the hard
            # ensemble pseudo-label
            loss_aux_t = cross_entropy(aux_t, label, divisor=label_divisor)
            metrics["loss_target_aux"] = loss_aux_t.detach()
            total = total + cfg.lambda_target * cfg.lambda_seg * loss_aux_t
        metrics["loss_target"] = (cfg.lambda_target * tgt_loss).detach()
        return spatial.join(total, space), metrics

    def step(state: TrainState, xs: torch.Tensor, ys: torch.Tensor, xt: torch.Tensor):
        heights = (tuple(xs.shape[1:3]), tuple(ys.shape[-2:]), tuple(xt.shape[1:3]))
        if cfg.concat_batches and space is not None:
            _own_rows(space, xs, xt)  # --sp divides each height
            (ys,) = _own_rows(space, ys)
            xs, xt = _canvas_rows(space, _canvas(heights[0], heights[2])[0], xs, xt)
        else:
            xs, ys, xt = _own_rows(space, xs, ys, xt)
        xs, ys = _prepare_inputs(xs, ys, cfg)
        xt, _ = _prepare_inputs(xt, None, cfg)
        with anomaly_mode(cfg.debug_nans), spatial.training(space):
            total, metrics = _step_loss(state, loss_fn, xs, ys, xt, heights)
            lr = _apply_update(state, total, cfg)
        return state, _finish_metrics(metrics, total, lr)

    return step


def make_eval_step(cfg: TrainConfig, model, num_eval_classes: int | None = None,
                   space: SpaceGroup | None = None):
    """Validation step: forward → upsample to label size → argmax → CM
    partial; the multi-scale evaluator with the single scale-1.0 head
    (``space``: its step over this rank's rows, ``step(x, y, heights)``)."""
    from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step

    return make_multiscale_eval_step(
        cfg, model, scales=(1.0,), flip=False, num_eval_classes=num_eval_classes, space=space
    )
