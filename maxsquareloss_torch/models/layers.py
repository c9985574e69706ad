"""NN primitives for the DeepLabV2 backbone (port of
``maxsquareloss_tpu/models/layers.py``).

Frozen BatchNorm is folded into a constant per-channel ``scale``/``bias``
pair held as buffers: never parameters, never updated, so ``module.train()``
cannot move it. Activations inside the model are NCHW tensors in
``torch.channels_last`` memory format; kernels are OIHW as in torch.

Mixed precision as in the JAX package: parameters and BN buffers stay
float32, each conv casts its weight (and adds its bias, cast) to the
activation's dtype where it is used, and frozen BN runs in the activation's
dtype. The casts are explicit (``torch.autocast`` keeps another cast list
and does not reach the fused block's autograd Function); the weight's
gradient comes back to float32 through the cast.

``aspp_sum`` (a TPU lane-padding rewrite of the summed ASPP head) has no
counterpart here: the head is a plain sum of four dilated convs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # torch BatchNorm2d default


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the activation's dtype (``conv2d`` of the JAX
    package): the weight cast to x's dtype, the bias cast and added after
    the conv, as its own op."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding,
                     self.dilation, self.groups)
        return y if self.bias is None else y + self.bias.to(y.dtype).view(1, -1, 1, 1)


class FrozenBN(nn.Module):
    """Frozen BatchNorm as folded affine: ``x * scale + bias`` per channel.

    ``scale = gamma / sqrt(running_var + eps)``,
    ``bias = beta - running_mean * scale`` — folded once when weights are
    loaded (``fold_bn``, ``convert.load_reference_state_dict``).
    """

    def __init__(self, channels: int, scale: float = 1.0):
        super().__init__()
        self.register_buffer("scale", torch.full((channels,), float(scale)))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.view(1, -1, 1, 1).to(x.dtype) + self.bias.view(
            1, -1, 1, 1
        ).to(x.dtype)


def fold_bn(
    gamma: np.ndarray, beta: np.ndarray, mean: np.ndarray, var: np.ndarray,
    eps: float = BN_EPS,
) -> tuple[np.ndarray, np.ndarray]:
    """Fold torch BN (gamma, beta, running_mean, running_var) → (scale, bias)."""
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def max_pool_ceil() -> nn.MaxPool2d:
    """The caffe-style stem pool: 3x3, stride 2, padding 1, ceil mode."""
    return nn.MaxPool2d(3, stride=2, padding=1, ceil_mode=True)


def kaiming_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """He-normal fan_out init of an OIHW kernel (torch resnet convention)."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def classifier_normal_(
    w: torch.Tensor, generator: torch.Generator, std: float = 0.01
) -> torch.Tensor:
    """N(0, 0.01) init used by the reference for ASPP classifier convs."""
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)
