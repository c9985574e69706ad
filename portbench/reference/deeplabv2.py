"""Plain DeepLabV2-ResNet101, multi-level, as the MaxSquareLoss code defines it.

A frozen copy for the benchmark's output check: plain ``torch`` operations
over a reference-layout state dict (``conv1.weight``, ``bn1.{weight,bias,
running_mean,running_var}``, ``layerL.B.conv{1,2,3}``, ``bn{1,2,3}``,
``downsample.{0,1}``, ``layer{5,6}.conv2d_list.i.{weight,bias}``), NCHW,
in float32 unless a caller asks otherwise. It imports nothing of the
program under test.

- caffe ResNet: 7x7/2 stem with padding 3, BN, ReLU, a 3x3/2 max pool with
  padding 1 in ceil mode; stages of (3, 4, 23, 3) bottlenecks with the
  stride on each stage's first 1x1 conv, layer3 at dilation 2 and layer4 at
  dilation 4 (output stride 8); a downsample branch on the first block of
  every stage whose stride or width changes or that is dilated.
- BN frozen: ``(x - running_mean) / sqrt(running_var + eps) * weight + bias``.
- V2 ASPP heads: four 3x3 convs with bias at dilations 6, 12, 18, 24,
  summed; ``layer5`` reads layer3 (aux), ``layer6`` reads layer4 (main).

``quant``: a function applied to every conv's input and weight before the
conv (the lower-precision control); None computes as given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PLANES = (64, 128, 256, 512)
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
ASPP_DILATIONS = (6, 12, 18, 24)
EXPANSION = 4
BN_EPS = 1e-5


def needs_downsample(stage: int, block: int, in_ch: int) -> bool:
    return block == 0 and (STRIDES[stage] != 1 or in_ch != PLANES[stage] * EXPANSION
                           or DILATIONS[stage] in (2, 4))


def layout(blocks, num_classes: int, multi: bool = True) -> list[tuple[str, tuple[int, ...]]]:
    """Every tensor of the state dict as (key, shape), in model order."""
    out = [("conv1.weight", (64, 3, 7, 7))]
    out += bn_layout("bn1", 64)
    in_ch = 64
    for s, n in enumerate(blocks):
        planes = PLANES[s]
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            out.append((f"{p}.conv1.weight", (planes, in_ch, 1, 1)))
            out += bn_layout(f"{p}.bn1", planes)
            out.append((f"{p}.conv2.weight", (planes, planes, 3, 3)))
            out += bn_layout(f"{p}.bn2", planes)
            out.append((f"{p}.conv3.weight", (planes * EXPANSION, planes, 1, 1)))
            out += bn_layout(f"{p}.bn3", planes * EXPANSION)
            if needs_downsample(s, b, in_ch):
                out.append((f"{p}.downsample.0.weight", (planes * EXPANSION, in_ch, 1, 1)))
                out += bn_layout(f"{p}.downsample.1", planes * EXPANSION)
            in_ch = planes * EXPANSION
    for head, cin in (("layer5", 1024), ("layer6", 2048)):
        if head == "layer5" and not multi:
            continue
        for i in range(len(ASPP_DILATIONS)):
            out.append((f"{head}.conv2d_list.{i}.weight", (num_classes, cin, 3, 3)))
            out.append((f"{head}.conv2d_list.{i}.bias", (num_classes,)))
    return out


def bn_layout(prefix: str, ch: int) -> list[tuple[str, tuple[int, ...]]]:
    return [(f"{prefix}.{k}", (ch,)) for k in ("weight", "bias", "running_mean", "running_var")]


def is_bn(key: str) -> bool:
    return key.endswith(("running_mean", "running_var")) or ".bn" in key or key.startswith(
        "bn1.") or ".downsample.1." in key


def trainable(key: str) -> bool:
    """Conv weights and head biases train; frozen BN does not."""
    return not is_bn(key)


def head_param(key: str) -> bool:
    """The classifier heads, which train at ``head_lr_mult`` times the LR."""
    return key.startswith(("layer5.", "layer6."))


def _bn(x, sd, prefix):
    scale = sd[f"{prefix}.weight"] / torch.sqrt(sd[f"{prefix}.running_var"] + BN_EPS)
    shift = sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * scale
    return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def _conv(x, w, quant, **kw):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, **kw)


def _block(x, sd, p, stride, dilation, downsample, quant):
    y = F.relu(_bn(_conv(x, sd[f"{p}.conv1.weight"], quant, stride=stride), sd, f"{p}.bn1"))
    y = F.relu(_bn(_conv(y, sd[f"{p}.conv2.weight"], quant, padding=dilation,
                         dilation=dilation), sd, f"{p}.bn2"))
    y = _bn(_conv(y, sd[f"{p}.conv3.weight"], quant), sd, f"{p}.bn3")
    if downsample:
        x = _bn(_conv(x, sd[f"{p}.downsample.0.weight"], quant, stride=stride), sd,
                f"{p}.downsample.1")
    return F.relu(y + x)


def _head(x, sd, head, quant):
    out = None
    for i, d in enumerate(ASPP_DILATIONS):
        y = _conv(x, sd[f"{head}.conv2d_list.{i}.weight"], quant, padding=d, dilation=d)
        y = y + sd[f"{head}.conv2d_list.{i}.bias"].view(1, -1, 1, 1)
        out = y if out is None else out + y
    return out


def forward(sd, x, blocks, aux: bool = True, quant=None):
    """(N, 3, H, W) normalized images → (aux logits or None, main logits),
    each (N, C, H', W') at output stride 8."""
    y = F.relu(_bn(_conv(x, sd["conv1.weight"], quant, stride=2, padding=3), sd, "bn1"))
    y = F.max_pool2d(y, 3, stride=2, padding=1, ceil_mode=True)
    in_ch, y3 = 64, None
    for s, n in enumerate(blocks):
        for b in range(n):
            down = needs_downsample(s, b, in_ch)
            y = _block(y, sd, f"layer{s + 1}.{b}", STRIDES[s] if b == 0 else 1, DILATIONS[s],
                       down, quant)
            in_ch = PLANES[s] * EXPANSION
        if s == 2:
            y3 = y
    aux_out = _head(y3, sd, "layer5", quant) if aux and "layer5.conv2d_list.0.weight" in sd \
        else None
    return aux_out, _head(y, sd, "layer6", quant)

