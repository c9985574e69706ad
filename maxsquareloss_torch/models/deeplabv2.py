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

Compute dtype (``DeepLabV2Config.compute_dtype``, float32 or bfloat16):
the input is cast once at the stem; parameters and BN buffers stay float32
and every conv casts its weight where it is used (``layers.Conv2d``); the
identity blocks run the kernel's instance of that dtype (eval: HWIO copies
packed in it; training: ``FusedBottleneckFn`` casts the fp32 HWIO views);
both heads' logits come back float32, as the JAX package's
``apply_deeplabv2``; the ASPP heads sum their four convs in the compute
dtype in every forward (``Classifier``). ``remat="stages"``
checkpoints each of the four ResNet stages (the JAX package's
``jax.checkpoint``): their
activations, the fused blocks' saved h1/h2 among them, are dropped after
the forward and recomputed in the backward.

Masked canvas (the UDA step's ``--concat_batches`` at unequal crops):
images of different sizes are zero-padded at the bottom and right onto one
canvas, and ``forward(x, masks=make_canvas_masks(...))`` re-zeroes the pad
region before every op that reads neighbours (the stem's maxpool, each
block's 3x3, the ASPP heads), as the JAX package's ``apply_deeplabv2``
does. The valid pixels then see exactly the zero padding of a forward of
the unpadded image. The identity blocks take the per-image valid extents
and zero h1 inside the kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from maxsquareloss_torch.kernels.fused_block import (
    FusedBottleneckFn,
    fused_bottleneck,
    fused_bottleneck_reference,
    valid_mask,
)
from maxsquareloss_torch.models.layers import (
    Conv2d,
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


class CanvasMask(NamedTuple):
    """The pad region of a canvas batch at one resolution: ``mask`` the 0/1
    float (N, 1, H, W) channels_last tensor for the PyTorch multiplies,
    ``valid`` each image's (valid rows, valid columns) as a contiguous
    (N, 2) int32 tensor for the fused bottleneck kernel."""

    mask: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DeepLabV2Config:
    num_classes: int = 19
    multi_level: bool = True
    blocks: tuple[int, ...] = RESNET101_BLOCKS
    compute_dtype: torch.dtype = torch.float32
    # '' | 'stages': checkpoint each ResNet stage (activations recomputed in
    # the backward instead of held)
    remat: str = ""


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          dilation: int = 1, bias: bool = False) -> nn.Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=padding,
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
            # The eval kernel's weights: each conv kernel in HWIO order in
            # the compute dtype, flattened to a 2-D (kh*kw*Cin, Cout) matrix
            # so that .to(memory_format=...) leaves it contiguous. Not saved;
            # made by DeepLabV2.pack_weights.
            for i in (1, 2, 3):
                self.register_buffer(f"w{i}_hwio", None, persistent=False)

    @property
    def fusable(self) -> bool:
        return self.downsample is None and self.stride == 1

    @torch.no_grad()
    def pack_weights(self, dtype: torch.dtype) -> None:
        for i, conv in enumerate((self.conv1, self.conv2, self.conv3), 1):
            w = conv.weight
            hwio = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).to(dtype)
            hwio = hwio.contiguous()  # a 1x1 kernel's permuted reshape is a view
            setattr(self, f"w{i}_hwio", hwio)

    def _hwio(self, i: int) -> torch.Tensor:
        cout, cin, kh, kw = getattr(self, f"conv{i}").weight.shape
        return getattr(self, f"w{i}_hwio").view(kh, kw, cin, cout)

    def forward(self, x: torch.Tensor, kernel, train_kernel,
                mask: CanvasMask | None = None) -> torch.Tensor:
        """``kernel`` (no grad, packed HWIO weights in the compute dtype)
        and ``train_kernel`` (grad enabled, fp32 HWIO views of
        ``conv{i}.weight``, cast by the kernel's Function or plain version):
        the fused bottleneck or its plain version, for the identity blocks,
        which take ``mask``'s valid extents; the others run as cuDNN convs
        and multiply h1 by ``mask``'s 0/1 mask before conv2."""
        valid = None if mask is None else mask.valid
        if self.fusable:
            bn = (self.bn1.scale, self.bn1.bias, self.bn2.scale, self.bn2.bias,
                  self.bn3.scale, self.bn3.bias)
            if torch.is_grad_enabled():
                w = (getattr(self, f"conv{i}").weight.permute(2, 3, 1, 0) for i in (1, 2, 3))
                return train_kernel(x, *w, *bn, self.dilation, valid)
            return kernel(x, self._hwio(1), self._hwio(2), self._hwio(3), *bn,
                          self.dilation, valid)
        y = F.relu(self.bn1(self.conv1(x)))
        if mask is not None:
            y = y * mask.mask.to(y.dtype)
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Classifier(nn.Module):
    """V2-style ASPP: four parallel dilated 3x3 convs in x's dtype, outputs
    summed in it (the JAX package's training form). Its eval form
    (``aspp_matmul``: the 36 taps' outputs in the compute dtype summed in
    float32) is not mirrored: in bf16 the eval logits keep the training
    form's roundings, within the tolerance PERF.md section 2 states against
    the JAX eval path; in float32 the two forms are one sum in two orders."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            _conv(in_ch, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in ASPP_DILATIONS
        )

    def forward(self, x: torch.Tensor, mask: CanvasMask | None = None) -> torch.Tensor:
        if mask is not None:
            x = x * mask.mask.to(x.dtype)
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
        # the packed weights are made here and again whenever a state dict is
        # loaded, by init_deeplabv2 after its in-place init, and by the train
        # steps after every optimizer step
        self.register_load_state_dict_post_hook(lambda model, _: model.pack_weights())
        self.pack_weights()

    def _stage(self, layer: nn.Sequential, x: torch.Tensor,
               mask: CanvasMask | None) -> torch.Tensor:
        def run(y):
            for block in layer:
                y = block(y, self.block_fn, self.train_block_fn, mask)
            return y

        if self.cfg.remat == "stages" and torch.is_grad_enabled():
            # the forward draws no random numbers: no RNG state to replay
            return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                                     preserve_rng_state=False)
        return run(x)

    def pack_weights(self) -> None:
        """Refresh the eval kernel's HWIO weights (in the compute dtype)
        from the convs."""
        for m in self.modules():
            if isinstance(m, Bottleneck) and m.fusable:
                m.pack_weights(self.cfg.compute_dtype)

    def forward(self, x: torch.Tensor, aux: bool = True,
                masks: dict[str, CanvasMask] | None = None):
        """(N, H, W, 3) normalized images → (aux_or_None, main), each
        (N, H/8, W/8, num_classes) float32 in either compute dtype.
        ``aux=False`` skips the layer5 head (the eval/predict path reads only
        the main head). ``masks`` (``make_canvas_masks``): a canvas batch
        whose pad region is re-zeroed before the maxpool (``pool_in``), before every block's 3x3 (``os4``
        in layer1, ``os8`` in layers 2-4) and before both heads (``os8``)."""
        m = masks or {}
        y = x.to(self.cfg.compute_dtype).permute(0, 3, 1, 2)
        y = y.contiguous(memory_format=torch.channels_last)
        y = F.relu(self.bn1(self.conv1(y)))
        if masks is not None:
            y = y * m["pool_in"].mask.to(y.dtype)
        y = self.pool(y)
        y = self._stage(self.layer1, y, m.get("os4"))
        y = self._stage(self.layer2, y, m.get("os8"))
        y3 = self._stage(self.layer3, y, m.get("os8"))
        aux_out = (
            self.layer5(y3, m.get("os8")) if aux and self.cfg.multi_level else None
        )
        main = self.layer6(self._stage(self.layer4, y3, m.get("os8")), m.get("os8"))

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


def _valid_sizes(hw: tuple[int, int]) -> dict[str, tuple[int, int]]:
    """Feature-map extents of an (H, W) input at the three mask points:
    ``pool_in`` after the conv 7x7/2 p3, ``os4`` after the ceil-mode
    maxpool 3x3/2 p1, ``os8`` after layer2's 1x1 stride 2 (layers 2-4 and
    both heads)."""

    def conv1(v: int) -> int:
        return (v + 2 * 3 - 7) // 2 + 1

    def pool(v: int) -> int:
        return math.ceil((v + 2 * 1 - 3) / 2) + 1

    def stride2(v: int) -> int:
        return (v - 1) // 2 + 1

    h1, w1 = conv1(hw[0]), conv1(hw[1])
    h2, w2 = pool(h1), pool(w1)
    return {"pool_in": (h1, w1), "os4": (h2, w2), "os8": (stride2(h2), stride2(w2))}


def valid_logits_hw(hw: tuple[int, int]) -> tuple[int, int]:
    """(H, W) of the logits a plain forward of an (H, W) input produces."""
    return _valid_sizes(hw)["os8"]


def make_canvas_masks(
    canvas_hw: tuple[int, int],
    groups: list[tuple[int, tuple[int, int]]],
    device: str | torch.device = "cpu",
) -> dict[str, CanvasMask] | None:
    """The masks of a batch of groups padded at the bottom and right onto a
    shared (H, W) canvas, by mask point (``pool_in``, ``os4``, ``os8``).

    ``groups``: [(n_images, (valid H, valid W)), ...] in batch order.
    Returns None when every group fills the canvas (nothing to mask).
    """
    canvas_hw = tuple(canvas_hw)
    if all(tuple(hw) == canvas_hw for _, hw in groups):
        return None
    canvas = _valid_sizes(canvas_hw)
    masks = {}
    for key, (ch, cw) in canvas.items():
        valid = torch.tensor([_valid_sizes(tuple(hw))[key] for n, hw in groups
                              for _ in range(n)], dtype=torch.int32, device=device)
        mask = valid_mask(valid, ch, cw).contiguous(memory_format=torch.channels_last)
        masks[key] = CanvasMask(mask, valid)
    return masks
