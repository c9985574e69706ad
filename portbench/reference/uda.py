"""Plain UDA training step of MaxSquareLoss (multi-level, IW max-squares).

One step over a source batch (images, labels) and a target batch (images):

- both heads' logits upsampled (bilinear, align_corners) to the label size
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
- autograd's backward, then SGD by hand: ``d = g + wd * p``, a momentum
  buffer seeded with the first ``d``, ``p -= lr * mult * buf`` at the poly
  LR ``lr * (1 - it / iter_max) ** power``, heads (layer5, layer6) at 10x.

Inputs are uint8 NHWC RGB images, normalized here as the caffe protocol
does (BGR minus the mean), and int labels. Nothing of the program under
test is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import deeplabv2

IMG_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)


def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) RGB → float32 (N, 3, H, W) BGR minus the mean."""
    x = x_uint8.float().flip(-1) - torch.tensor(IMG_MEAN_BGR, device=x_uint8.device)
    return x.permute(0, 3, 1, 2).contiguous()


def upsample(logits: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(logits, size=tuple(hw), mode="bilinear", align_corners=True)


def ce(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    total = F.cross_entropy(logits, label.long(), ignore_index=-1, reduction="sum")
    return total / (label != -1).sum().clamp_min(1)


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


def uda_loss(sd, blocks, train: dict, xs, ys, xt, quant=None):
    """The step's total loss, a tensor with grad."""
    src_aux, src_main = deeplabv2.forward(sd, normalize(xs), blocks, quant=quant)
    label_hw = ys.shape[-2:]
    src_main, src_aux = upsample(src_main, label_hw), upsample(src_aux, label_hw)
    loss_source = ce(src_main, ys) + train["lambda_seg"] * ce(src_aux, ys)
    tgt_aux, tgt_main = deeplabv2.forward(sd, normalize(xt), blocks, quant=quant)
    tgt_hw = xt.shape[1:3]
    tgt_main, tgt_aux = upsample(tgt_main, tgt_hw), upsample(tgt_aux, tgt_hw)
    prob_main = F.softmax(tgt_main, dim=1)
    with torch.no_grad():
        label = guidance(prob_main, F.softmax(tgt_aux, dim=1), train["threshold"],
                         train["guidance_mask"])
    iw = iw_max_square(prob_main, label if train["iw_hist"] == "guidance" else None,
                       train["IW_ratio"])
    aux_t = ce(tgt_aux, label)
    total = (loss_source + train["lambda_target"] * iw
             + train["lambda_target"] * train["lambda_seg"] * aux_t)
    return total


def poly_lr(train: dict, iteration: int) -> float:
    return train["lr"] * max(1.0 - iteration / train["iter_max"], 0.0) ** train["poly_power"]


def head_param(key: str) -> bool:
    return key.startswith(("layer5.", "layer6."))


class SGD:
    """SGD with coupled weight decay and momentum (no dampening, no
    Nesterov), the heads at ``head_lr_mult`` times the LR."""

    def __init__(self, params: dict, train: dict):
        self.params, self.train = params, train
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
            mult = self.train["head_lr_mult"] if head_param(k) else 1.0
            p.sub_(lr * mult * self.buf[k])
            p.grad = None


def train_steps(sd0: dict, blocks, train: dict, batches, quant=None, first_iteration: int = 0):
    """Steps from ``sd0`` (not modified) over ``batches`` of (xs, ys, xt):
    each step's total loss, each trainable leaf's first gradient norm and
    its change's norm after the last step (float64 numbers, by key)."""
    sd = {k: v.detach().clone().float() for k, v in sd0.items()}
    params = {k: v.requires_grad_(True) for k, v in sd.items() if deeplabv2.trainable(k)}
    opt = SGD(params, train)
    losses, grad_norms = [], {}
    for i, (xs, ys, xt) in enumerate(batches):
        total = uda_loss(sd, blocks, train, xs, ys, xt, quant)
        total.backward()
        losses.append(float(total.detach()))
        if i == 0:
            grad_norms = {k: float(p.grad.double().norm()) for k, p in params.items()}
        del total
        opt.step(first_iteration + i)
    change_norms = {k: float((params[k].detach() - sd0[k].float()).double().norm())
                    for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
