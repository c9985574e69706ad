"""DeepLabV2 ResNet-101 multi-level model as an ``nn.Module`` (port of
``maxsquareloss_tpu/models/deeplabv2.py``).

- caffe-style ResNet-101: 7x7/2 stem, ceil-mode 3x3/2 maxpool, layers
  [3, 4, 23, 3]; layer3 dilation 2 and layer4 dilation 4 at stride 1 →
  output stride 8. The stride sits on each stage's first 1x1 conv.
- Frozen BN folded into ``scale``/``bias`` buffers (``layers.FrozenBN``).
- V2 ASPP heads: four parallel dilated 3x3 convs (6/12/18/24), summed.
  ``layer6`` on layer4 (main), ``layer5`` on layer3 (aux, multi-level).

State-dict keys follow the reference (``conv1``, ``bn1``,
``layerL.B.conv{1,2,3}``, ``bn{1,2,3}``, ``downsample.{0,1}``,
``layer{5,6}.conv2d_list.i``), with each BN as its folded buffers.

Public layout is NHWC as in the JAX package: ``forward`` takes (N, H, W, 3)
and returns (N, H/8, W/8, C) logits. Inside, ``x.permute(0, 3, 1, 2)`` is
an NCHW view with channels-last strides and the trunk stays in
``torch.channels_last``. Every stride-1 block without a downsample (29 of
ResNet-101's 33) runs as one fused kernel: with grad enabled (training)
``kernels.fused_block.FusedBottleneckFn``, whose gradient reaches
``conv{1,2,3}.weight``; without (eval, predict)
``kernels.fused_block.fused_bottleneck`` on HWIO copies of the weights
that ``pack_weights`` makes. The stem, the 4 downsample blocks and the
heads are cuDNN convs. ``param_groups`` gives the optimizer's 1x/10x
groups.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from maxsquareloss_torch.kernels.fused_block import (
    FusedBottleneckFn,
    fused_bottleneck,
    fused_bottleneck_reference,
)
from maxsquareloss_torch.models.layers import (
    FrozenBN,
    classifier_normal_,
    kaiming_normal_,
    max_pool_ceil,
)
from maxsquareloss_torch.utils.device import resolve_device

RESNET101_BLOCKS = (3, 4, 23, 3)
LAYER_PLANES = (64, 128, 256, 512)
LAYER_STRIDES = (1, 2, 1, 1)
LAYER_DILATIONS = (1, 1, 2, 4)
ASPP_DILATIONS = (6, 12, 18, 24)
EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class DeepLabV2Config:
    num_classes: int = 19
    multi_level: bool = True
    blocks: tuple[int, ...] = RESNET101_BLOCKS


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          dilation: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """caffe ResNet bottleneck (stride on conv1, conv2 padding = dilation)."""

    def __init__(self, in_ch: int, planes: int, stride: int, dilation: int,
                 downsample: bool):
        super().__init__()
        out_ch = planes * EXPANSION
        self.stride, self.dilation = stride, dilation
        self.conv1 = _conv(in_ch, planes, 1, stride=stride)
        self.bn1 = FrozenBN(planes)
        self.conv2 = _conv(planes, planes, 3, padding=dilation, dilation=dilation)
        self.bn2 = FrozenBN(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        # bn3 scale 0.1 at random init: with identity frozen BN the residual
        # variance would double per block; real runs load converted stats
        self.bn3 = FrozenBN(out_ch, scale=0.1)
        self.downsample = (
            nn.Sequential(_conv(in_ch, out_ch, 1, stride=stride), FrozenBN(out_ch))
            if downsample else None
        )
        if self.fusable:
            # The eval kernel's weights: each conv kernel in HWIO order,
            # flattened to a 2-D (kh*kw*Cin, Cout) matrix so that
            # .to(memory_format=...) leaves it contiguous. Not saved; made
            # here and again whenever a state dict is loaded, by
            # init_deeplabv2 after its in-place init, and by the train steps
            # after every optimizer step.
            for i in (1, 2, 3):
                self.register_buffer(f"w{i}_hwio", None, persistent=False)
            self.register_load_state_dict_post_hook(
                lambda module, _: module.pack_weights()
            )
            self.pack_weights()

    @property
    def fusable(self) -> bool:
        return self.downsample is None and self.stride == 1

    @torch.no_grad()
    def pack_weights(self) -> None:
        for i, conv in enumerate((self.conv1, self.conv2, self.conv3), 1):
            w = conv.weight
            hwio = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()
            setattr(self, f"w{i}_hwio", hwio)

    def _hwio(self, i: int) -> torch.Tensor:
        cout, cin, kh, kw = getattr(self, f"conv{i}").weight.shape
        return getattr(self, f"w{i}_hwio").view(kh, kw, cin, cout)

    def forward(self, x: torch.Tensor, kernel, train_kernel) -> torch.Tensor:
        """``kernel`` (no grad, packed HWIO weights) and ``train_kernel``
        (grad enabled, HWIO views of ``conv{i}.weight``): the fused
        bottleneck or its plain version, for the identity blocks; the others
        run as cuDNN convs."""
        if self.fusable:
            bn = (self.bn1.scale, self.bn1.bias, self.bn2.scale, self.bn2.bias,
                  self.bn3.scale, self.bn3.bias)
            if torch.is_grad_enabled():
                w = (getattr(self, f"conv{i}").weight.permute(2, 3, 1, 0) for i in (1, 2, 3))
                return train_kernel(x, *w, *bn, self.dilation)
            return kernel(x, self._hwio(1), self._hwio(2), self._hwio(3), *bn,
                          self.dilation)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Classifier(nn.Module):
    """V2-style ASPP: four parallel dilated 3x3 convs, outputs summed."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            _conv(in_ch, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in ASPP_DILATIONS
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = None
        for conv in self.conv2d_list:
            y = conv(x)
            out = y if out is None else out + y
        return out


class DeepLabV2(nn.Module):
    """DeepLabV2-ResNet101, NHWC in and out.

    ``plain_blocks=True`` routes the identity blocks to the plain PyTorch
    version of the fused kernel (for holding the kernel path against it).
    After changing conv weights in place outside the train steps, call
    ``pack_weights`` before an eval forward.
    """

    def __init__(self, cfg: DeepLabV2Config = DeepLabV2Config(),
                 plain_blocks: bool = False):
        super().__init__()
        self.cfg = cfg
        self.block_fn = fused_bottleneck_reference if plain_blocks else fused_bottleneck
        self.train_block_fn = (
            fused_bottleneck_reference if plain_blocks else FusedBottleneckFn.apply
        )
        self.conv1 = _conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = FrozenBN(64)
        self.pool = max_pool_ceil()
        in_ch = 64
        for li, (n_blocks, planes, stride, dilation) in enumerate(
            zip(cfg.blocks, LAYER_PLANES, LAYER_STRIDES, LAYER_DILATIONS)
        ):
            blocks = []
            for bi in range(n_blocks):
                # downsample on the first block when the stride/width changes
                # or the layer is dilated (layers 3 and 4)
                need_ds = bi == 0 and (
                    stride != 1 or in_ch != planes * EXPANSION or dilation in (2, 4)
                )
                blocks.append(Bottleneck(in_ch, planes, stride if bi == 0 else 1,
                                         dilation, need_ds))
                in_ch = planes * EXPANSION
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        if cfg.multi_level:
            self.layer5 = Classifier(1024, cfg.num_classes)
        self.layer6 = Classifier(2048, cfg.num_classes)

    def _stage(self, layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for block in layer:
            x = block(x, self.block_fn, self.train_block_fn)
        return x

    def pack_weights(self) -> None:
        """Refresh the eval kernel's HWIO weights from the convs."""
        for m in self.modules():
            if isinstance(m, Bottleneck) and m.fusable:
                m.pack_weights()

    def forward(self, x: torch.Tensor, aux: bool = True):
        """(N, H, W, 3) normalized images → (aux_or_None, main), each
        (N, H/8, W/8, num_classes) float32. ``aux=False`` skips the layer5
        head (the eval/predict path reads only the main head)."""
        y = x.float().permute(0, 3, 1, 2)
        y = y.contiguous(memory_format=torch.channels_last)
        y = self.pool(F.relu(self.bn1(self.conv1(y))))
        y = self._stage(self.layer1, y)
        y = self._stage(self.layer2, y)
        y3 = self._stage(self.layer3, y)
        aux_out = (
            self.layer5(y3) if aux and self.cfg.multi_level else None
        )
        main = self.layer6(self._stage(self.layer4, y3))

        def nhwc(t):
            return t.permute(0, 2, 3, 1).float()

        return (None if aux_out is None else nhwc(aux_out)), nhwc(main)


def init_deeplabv2(
    cfg: DeepLabV2Config,
    generator: torch.Generator | int,
    device: str | torch.device | None = None,
) -> DeepLabV2:
    """Random-init DeepLabV2 on ``device``: Kaiming fan_out normal for trunk
    convs, N(0, 0.01) for the heads with zero biases, frozen BN as identity
    except bn3 (scale 0.1).

    ``generator``: a (CPU) ``torch.Generator``, or an int seed, which draws
    the JAX package's weights for that seed (``init_deeplabv2(
    jax.random.key(seed))``, to a few ulp; ``utils/jax_random.py``).
    """
    device = resolve_device(device)
    model = DeepLabV2(cfg)
    if isinstance(generator, int):
        _init_as_jax(model, generator, device)
    else:
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv2d):
                if name.startswith(("layer5", "layer6")):
                    classifier_normal_(m.weight, generator)
                    nn.init.zeros_(m.bias)
                else:
                    kaiming_normal_(m.weight, generator)
    model.pack_weights()
    return model.to(device=device, memory_format=torch.channels_last).eval()


@torch.no_grad()
def _init_as_jax(model: DeepLabV2, seed: int, device: torch.device) -> None:
    """The JAX package's key tree: one key for the stem, one per block (split
    4 ways: conv1, conv2, conv3, downsample), one per head (split 4 ways, one
    per ASPP conv); each HWIO draw transposed to OIHW."""
    from maxsquareloss_torch.utils import jax_random

    def draw(conv: nn.Conv2d, k, std: float) -> None:
        cout, cin, kh, kw = conv.weight.shape
        w = jax_random.normal(k, (kh, kw, cin, cout), device) * torch.tensor(
            std, dtype=torch.float32, device=device)
        conv.weight.copy_(w.permute(3, 2, 0, 1))

    def kaiming(conv: nn.Conv2d, k) -> None:
        cout, _, kh, kw = conv.weight.shape
        draw(conv, k, math.sqrt(2.0 / (kh * kw * cout)))

    keys = iter(jax_random.split(jax_random.key(seed), 256))
    kaiming(model.conv1, next(keys))
    for li in range(1, 5):
        for block in getattr(model, f"layer{li}"):
            ks = jax_random.split(next(keys), 4)
            for conv, k in zip((block.conv1, block.conv2, block.conv3), ks):
                kaiming(conv, k)
            if block.downsample is not None:
                kaiming(block.downsample[0], ks[3])
    heads = (model.layer5, model.layer6) if model.cfg.multi_level else (model.layer6,)
    for head in heads:
        for conv, k in zip(head.conv2d_list, jax_random.split(next(keys), len(ASPP_DILATIONS))):
            draw(conv, k, 0.01)
            conv.bias.zero_()


def param_groups(model: DeepLabV2, head_mult: float = 10.0) -> list[dict]:
    """The optimizer's two groups (counterpart of ``lr_mult_tree``): the
    classifier heads ``layer5``/``layer6`` at ``head_mult`` x the LR, every
    other parameter at 1x, biases included. Each group carries its
    ``lr_mult``."""
    backbone, heads = [], []
    for name, p in model.named_parameters():
        (heads if name.startswith(("layer5.", "layer6.")) else backbone).append(p)
    return [{"params": backbone, "lr_mult": 1.0},
            {"params": heads, "lr_mult": head_mult}]


def valid_logits_hw(hw: tuple[int, int]) -> tuple[int, int]:
    """(H, W) of the logits a plain forward of an (H, W) input produces:
    conv 7x7/2 p3 → ceil-mode maxpool 3x3/2 p1 → layer2's 1x1 stride 2."""

    def os8(v: int) -> int:
        v = (v + 2 * 3 - 7) // 2 + 1
        v = math.ceil((v + 2 * 1 - 3) / 2) + 1
        return (v - 1) // 2 + 1

    return os8(hw[0]), os8(hw[1])
