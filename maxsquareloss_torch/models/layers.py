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

int8 sites (``QConv2d``, ``qconv2d``): a backbone conv whose weight was
quantized by ``models/quantize.py`` runs ``qconv2d`` of the JAX package:
the activation quantized per tensor, an exact int8 x int8 -> int32
product, a per-output-channel dequant back to the activation's dtype. The
calibration recorder (``_calib_recorder``, set by ``quantize.calibrate``)
sees every conv's input.

``aspp_matmul_forward`` is the eval form of the summed ASPP head (the JAX
package's ``_aspp_matmul_forward``): one product to the 36 taps' channels
in the activation's dtype, the taps' shifted slices summed in float32 as a
pairwise tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # torch BatchNorm2d default


# set by models/quantize.calibrate while it runs: called with (conv, input)
# by every conv before it computes
_calib_recorder = None


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the activation's dtype (``conv2d`` of the JAX
    package): the weight cast to x's dtype, the bias cast and added after
    the conv, as its own op. ``pad_h`` replaces the H padding (a spatial
    shard's window comes padded already: ``parallel/spatial.py``)."""

    def forward(self, x: torch.Tensor, pad_h: int | None = None) -> torch.Tensor:
        if _calib_recorder is not None:
            _calib_recorder(self, x)
        padding = self.padding if pad_h is None else (pad_h, self.padding[1])
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, padding,
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


def int8_patches(xq: torch.Tensor, kernel: int, stride: int, padding: int,
                 dilation: int) -> torch.Tensor:
    """The (N, Ho, Wo, k) int8 windows of a conv's input: ``xq`` NHWC int8,
    zero padded, each output pixel's taps in (kh, kw, Cin) order, k padded
    with zeros to a multiple of 8 (the int8 GEMM's requirement; exact: a
    zero column adds nothing). A 1x1 at stride s reads every s-th pixel."""
    n, h, w, c = xq.shape
    ho = (h + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    taps = [xq[:, a * dilation: a * dilation + (ho - 1) * stride + 1: stride,
               b * dilation: b * dilation + (wo - 1) * stride + 1: stride]
            for a in range(kernel) for b in range(kernel)]
    pad_k = -(kernel * kernel * c) % 8
    if pad_k:
        taps.append(xq.new_zeros((n, ho, wo, pad_k)))
    return taps[0].contiguous() if len(taps) == 1 else torch.cat(taps, dim=-1)


def int8_matmul(a: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """``a @ w_mat.T`` exactly, int8 x int8 -> int32: on the card the
    library's int8 GEMM (``torch._int_mm``, cuBLASLt; the JAX package's
    int8 conv is XLA's, not a Pallas kernel), on the CPU the plain int32
    product. ``w_mat``: (Cout, k) int8, contiguous."""
    if a.device.type == "cuda":
        return torch._int_mm(a, w_mat.t())
    if a.device.type != "cpu":
        raise ValueError(f"int8 conv: no product for device {a.device}")
    return torch.mm(a.int(), w_mat.t().int())


def qconv2d(x: torch.Tensor, w_mat: torch.Tensor, oscale: torch.Tensor,
            ascale_inv: torch.Tensor, kernel: int, stride: int = 1, padding: int = 0,
            dilation: int = 1) -> torch.Tensor:
    """int8 conv (``qconv2d`` of the JAX package): x (N, C, H, W,
    channels_last) to float32, times ``ascale_inv``, rounded half to even,
    clipped to +-127, int8; the int8 x int8 -> int32 product of its windows
    with ``w_mat`` ((Cout, k) int8 from ``QConv2d``); float32 times the
    per-output-channel ``oscale``, cast back to x's dtype. The int32 sum is
    exact, so it is the JAX conv's bit for bit in any order."""
    xq = torch.clamp(torch.round(x.permute(0, 2, 3, 1).float() * ascale_inv),
                     -127.0, 127.0).to(torch.int8)
    cols = int8_patches(xq, kernel, stride, padding, dilation)
    y = int8_matmul(cols.view(-1, cols.shape[-1]), w_mat)
    y = (y.float() * oscale).to(x.dtype)
    return y.view(*cols.shape[:3], -1).permute(0, 3, 1, 2)


class QConv2d(nn.Module):
    """An int8 conv site from ``weight``, the int8 OIHW kernel
    (``quantize._quantize_site``). Its buffers: ``w_mat`` the kernel as the
    (Cout, k) GEMM operand (taps in (kh, kw, Cin) order, k zero-padded to a
    multiple of 8), the one copy it holds; ``oscale`` (Cout,) float32 and
    ``ascale_inv`` () float32."""

    def __init__(self, weight: torch.Tensor, oscale: torch.Tensor, ascale_inv: torch.Tensor,
                 stride: int, padding: int, dilation: int):
        super().__init__()
        cout, _, _, self.kernel = weight.shape
        self.stride, self.padding, self.dilation = stride, padding, dilation
        w = weight.permute(0, 2, 3, 1).reshape(cout, -1)
        self.register_buffer("w_mat", F.pad(w, (0, -w.shape[1] % 8)).contiguous())
        self.register_buffer("oscale", oscale)
        self.register_buffer("ascale_inv", ascale_inv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qconv2d(x, self.w_mat, self.oscale, self.ascale_inv, self.kernel,
                       self.stride, self.padding, self.dilation)


def aspp_products(x: torch.Tensor, weights) -> torch.Tensor:
    """The eval form's one product: x (N, C, H, W) channels_last times the
    36 taps' kernels concatenated tap by tap, dilation-major, in x's dtype;
    (N, H, W, 36 * nc) NHWC. Per pixel: a spatial shard computes it on its
    own rows and exchanges these 36 * nc channels, not x's."""
    wflat = torch.cat([wt[:, :, a, b] for wt in weights for a in range(3) for b in range(3)])
    return torch.matmul(x.permute(0, 2, 3, 1), wflat.to(x.dtype).t())


def aspp_matmul_forward(x: torch.Tensor, weights, biases, dilations) -> torch.Tensor:
    """The summed ASPP head's eval form (``_aspp_matmul_forward`` of the JAX
    package): ``aspp_products`` (one product in x's dtype); each tap's
    slice of a zero-padded result, shifted by its offset, widened to
    float32 and summed as a pairwise tree; the biases added in float32.
    ``weights``: OIHW 3x3 kernels. Returns (N, nc, H, W) float32, a view
    of an NHWC tensor."""
    pad = max(dilations)
    zp = F.pad(aspp_products(x, weights), (0, 0, pad, pad, pad, pad))
    return aspp_tap_sum(zp, biases, dilations, x.shape[2])


def aspp_tap_sum(zp: torch.Tensor, biases, dilations, h: int) -> torch.Tensor:
    """The eval form's sum over ``zp``, the products padded by
    max(dilations) zero rows and columns on each side (a spatial shard's
    fetched window, padded where it passes the border): output rows
    [0, h) of the padded frame's interior, (N, nc, h, W) float32."""
    pad = max(dilations)
    nc = biases[0].shape[0]
    w = zp.shape[2] - 2 * pad
    taps = []
    for d in dilations:
        for a in range(3):
            for b in range(3):
                dy, dx, t = (a - 1) * d, (b - 1) * d, len(taps)
                taps.append(zp[:, pad + dy: pad + dy + h, pad + dx: pad + dx + w,
                               t * nc: (t + 1) * nc].float())
    while len(taps) > 1:
        nxt = [p + q for p, q in zip(taps[0::2], taps[1::2])]
        if len(taps) % 2:
            nxt.append(taps[-1])
        taps = nxt
    bias = 0
    for b in biases:  # Python's sum: ((0 + b0) + b1) + ...
        bias = bias + b.float()
    return (taps[0] + bias).permute(0, 3, 1, 2)
