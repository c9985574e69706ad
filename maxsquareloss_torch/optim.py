"""torch SGD over the model's two parameter groups, and the poly LR
(port of ``maxsquareloss_tpu/optim.py``).

``torch.optim.SGD`` with ``dampening=0, nesterov=False`` has the
semantics ``sgd_update`` replicates: weight decay coupled into the
gradient before momentum (``d = g + wd * p``), a momentum buffer seeded
with the first decayed gradient, then ``p -= lr * buf``. Each group's LR
is the poly LR times the group's ``lr_mult`` (1x backbone, 10x heads).
"""

from __future__ import annotations

import torch

from maxsquareloss_torch.models.deeplabv2 import param_groups


def make_sgd(model: torch.nn.Module, cfg) -> torch.optim.SGD:
    """SGD over ``param_groups(model)`` with ``cfg``'s momentum and decay."""
    return torch.optim.SGD(
        param_groups(model), lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, dampening=0, nesterov=False,
    )


def poly_lr(base_lr: float, iteration: int, max_iter: int, power: float = 0.9) -> float:
    """``lr0 * max(1 - iter/max_iter, 0)^power``: clamped at 0 past
    ``max_iter``, where the reference's formula would raise a negative
    base to a fractional power."""
    return base_lr * max(1.0 - iteration / max_iter, 0.0) ** power


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's LR = ``lr`` x its ``lr_mult``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
