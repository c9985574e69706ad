"""Plain UDA training step of MaxSquareLoss (IW max-squares, one or two heads).

One step over a source batch (images, labels) and a target batch (images),
through an architecture's plain forward (``Plain``), which gives the main
head's logits and, where the architecture has one, the aux head's:

- the heads' logits upsampled (bilinear, align_corners) to the label size
  (source) and to the target crop (target);
- source: pixel CE of the main head plus ``lambda_seg`` times the aux
  head's, each summed over the valid pixels (label != -1) and divided by
  their count (at least 1);
- target: softmax of both heads; the guidance label is the argmax of their
  mean where its largest value passes ``threshold`` (``ensemble``) or where
  either head's does (``per_head_or``), else -1; the IW max-squares loss
  ``-sum(p^2 * w[argmax p]) / (N*C)`` on the main head, with each image's
  class weights ``w_c = 1 / max(h_c^ratio * (sum h)^(1-ratio), 1)`` from a
  ``torch.histc`` of its argmax (``iw_hist == "argmax"``) or of its guidance
  label, detached; the aux head's CE on the guidance label;
- total = source + lambda_target * IW + lambda_target * lambda_seg * aux CE;
  without an aux head there is no guidance label and no guidance CE, as in
  the program's step;
- autograd's backward, then the architecture's optimizer: for DeepLabV2
  SGD by hand, ``d = g + wd * p``, a momentum buffer seeded with the first
  ``d``, ``p -= lr * mult * buf`` at the poly LR
  ``lr * (1 - it / iter_max) ** power``, heads at ``head_lr_mult``.

A data-parallel step's global batch is the ranks' shares together; it is
computed one share at a time (``global_backward``): each CE divided by its
valid count over the global batch, each share's total over the number of
shares, the gradients summed over the shares. Frozen BN and per-image IW
weights make the shares add up to the global batch's step exactly.

Inputs are uint8 NHWC RGB images, normalized here as the caffe protocol
does (BGR minus the mean), and int labels. Nothing of the program under
test is imported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

IMG_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)


@dataclasses.dataclass(frozen=True)
class Plain:
    """An architecture's plain reference: ``forward(sd, x, aux=True,
    quant=None)`` → (aux logits or None, main logits), each (N, C, H', W')
    from normalized (N, 3, H, W) images, ``quant`` applied to every conv's
    input and weight (``lowp.py``); ``trainable(key)``: the leaves that
    train; ``optimizer(params, train)``: an object whose ``step(iteration)``
    applies one update from the leaves' gradients and clears them."""

    forward: Callable
    trainable: Callable[[str], bool]
    optimizer: Callable


def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) RGB → float32 (N, 3, H, W) BGR minus the mean."""
    x = x_uint8.float().flip(-1) - torch.tensor(IMG_MEAN_BGR, device=x_uint8.device)
    return x.permute(0, 3, 1, 2).contiguous()


def upsample(logits: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(logits, size=tuple(hw), mode="bilinear", align_corners=True)


def ce(logits: torch.Tensor, label: torch.Tensor, divisor=None) -> torch.Tensor:
    """Summed pixel CE over ``divisor``, by default the valid count (at
    least 1)."""
    total = F.cross_entropy(logits, label.long(), ignore_index=-1, reduction="sum")
    return total / ((label != -1).sum().clamp_min(1) if divisor is None else divisor)


@torch.no_grad()
def guidance(prob_main, prob_aux, threshold: float, mask: str) -> torch.Tensor:
    ens = (prob_main + prob_aux) / 2
    if mask == "ensemble":
        confident = ens.max(1).values > threshold
    else:
        confident = (prob_main.max(1).values > threshold) | (prob_aux.max(1).values > threshold)
    return torch.where(confident, ens.argmax(1), torch.full_like(confident, -1, dtype=torch.long))


def iw_max_square(prob: torch.Tensor, label: torch.Tensor | None, ratio: float) -> torch.Tensor:
    n, c = prob.shape[:2]
    with torch.no_grad():
        argpred = prob.argmax(1)
        counted = argpred if label is None else label
        weights = []
        for i in range(n):
            hist = torch.histc(counted[i].float(), bins=c + 1, min=-1, max=c - 1)[1:]
            w = 1.0 / torch.clamp(hist.pow(ratio) * hist.sum().pow(1 - ratio), min=1.0)
            weights.append(w[argpred[i]])
        weights = torch.stack(weights).unsqueeze(1)
    return -(prob.pow(2) * weights).sum() / (n * c)


def uda_loss(sd, forward, train: dict, xs, ys, xt, quant=None, divisors=None, label=None):
    """The step's total loss, a tensor with grad. ``divisors``: the source
    CEs' and the guidance CE's (default: their own valid counts);
    ``label``: the target's guidance label, made beforehand (default: made
    here from this forward)."""
    src_div, label_div = divisors or (None, None)
    src_aux, src_main = forward(sd, normalize(xs), quant=quant)
    label_hw = ys.shape[-2:]
    src_main = upsample(src_main, label_hw)
    loss_source = ce(src_main, ys, src_div)
    if src_aux is not None:
        loss_source = loss_source + train["lambda_seg"] * ce(upsample(src_aux, label_hw), ys,
                                                             src_div)
    tgt_aux, tgt_main = forward(sd, normalize(xt), quant=quant)
    tgt_hw = xt.shape[1:3]
    tgt_main = upsample(tgt_main, tgt_hw)
    prob_main = F.softmax(tgt_main, dim=1)
    if tgt_aux is not None:
        tgt_aux = upsample(tgt_aux, tgt_hw)
        if label is None:
            with torch.no_grad():
                label = guidance(prob_main, F.softmax(tgt_aux, dim=1), train["threshold"],
                                 train["guidance_mask"])
    iw = iw_max_square(prob_main, label if train["iw_hist"] == "guidance" else None,
                       train["IW_ratio"])
    total = loss_source + train["lambda_target"] * iw
    if tgt_aux is not None:
        aux_t = ce(tgt_aux, label, label_div)
        total = total + train["lambda_target"] * train["lambda_seg"] * aux_t
    return total


@torch.no_grad()
def target_label(sd, forward, train: dict, xt, quant=None):
    """The target batch's guidance label, or None without an aux head."""
    tgt_aux, tgt_main = forward(sd, normalize(xt), quant=quant)
    if tgt_aux is None:
        return None
    tgt_hw = xt.shape[1:3]
    return guidance(F.softmax(upsample(tgt_main, tgt_hw), dim=1),
                    F.softmax(upsample(tgt_aux, tgt_hw), dim=1), train["threshold"],
                    train["guidance_mask"])


def global_backward(sd, forward, train: dict, shares, quant=None) -> float:
    """The gradient of a global batch's loss, one share (xs, ys, xt) at a
    time, summed into the leaves' ``.grad``: first each share's guidance
    label (a forward without grad), then each share's total with every CE
    over its global valid count divided by the number of shares, over the
    number of shares. Returns the global loss."""
    w = len(shares)
    labels = [target_label(sd, forward, train, xt, quant) for _, _, xt in shares]

    def divisor(ys):
        return sum((y != -1).sum() for y in ys).clamp_min(1).float() / w

    divisors = (divisor([ys for _, ys, _ in shares]),
                None if labels[0] is None else divisor(labels))
    loss = 0.0
    for (xs, ys, xt), label in zip(shares, labels, strict=True):
        total = uda_loss(sd, forward, train, xs, ys, xt, quant, divisors, label) / w
        total.backward()
        loss += float(total.detach())
        del total
    return loss


def poly_lr(train: dict, iteration: int) -> float:
    return train["lr"] * max(1.0 - iteration / train["iter_max"], 0.0) ** train["poly_power"]


class SGD:
    """SGD with coupled weight decay and momentum (no dampening, no
    Nesterov), the leaves that ``is_head`` names at ``head_lr_mult`` times
    the LR."""

    def __init__(self, params: dict, train: dict, is_head: Callable[[str], bool]):
        self.params, self.train, self.is_head = params, train, is_head
        self.buf: dict = {}

    @torch.no_grad()
    def step(self, iteration: int) -> None:
        lr = poly_lr(self.train, iteration)
        for k, p in self.params.items():
            d = p.grad + self.train["weight_decay"] * p
            if k in self.buf:
                self.buf[k].mul_(self.train["momentum"]).add_(d)
            else:
                self.buf[k] = d.clone()
            mult = self.train["head_lr_mult"] if self.is_head(k) else 1.0
            p.sub_(lr * mult * self.buf[k])
            p.grad = None


def train_steps(sd0: dict, plain: Plain, train: dict, steps, quant=None,
                first_iteration: int = 0):
    """Steps from ``sd0`` (not modified) over ``steps``, each a list of
    shares (xs, ys, xt) of one global batch (one share: a one-card step):
    each step's total loss, each trainable leaf's first gradient norm and
    its change's norm after the last step (float64 numbers, by key)."""
    sd = {k: v.detach().clone().float() for k, v in sd0.items()}
    params = {k: v.requires_grad_(True) for k, v in sd.items() if plain.trainable(k)}
    opt = plain.optimizer(params, train)
    losses, grad_norms = [], {}
    for i, shares in enumerate(steps):
        if len(shares) == 1:
            total = uda_loss(sd, plain.forward, train, *shares[0], quant)
            total.backward()
            losses.append(float(total.detach()))
            del total
        else:
            losses.append(global_backward(sd, plain.forward, train, shares, quant))
        if i == 0:
            grad_norms = {k: float(p.grad.double().norm()) for k, p in params.items()}
        opt.step(first_iteration + i)
    change_norms = {k: float((params[k].detach() - sd0[k].float()).double().norm())
                    for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
