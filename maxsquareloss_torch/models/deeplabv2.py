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
``apply_deeplabv2``. The ASPP heads have the JAX package's two forms
(``Classifier``): the training form sums their four convs in the compute
dtype; the eval form (``DeepLabV2Config.aspp_matmul``, which
``train.steps.model_config(cfg, eval_mode=True)`` sets, or ``eval_form``
on a model built for training, as the evaluator, predict and calibration
take it) sums the 36 taps' products in float32. ``remat="stages"``
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

int8 sites (``models/quantize.py``): a conv whose weight was quantized is a
``layers.QConv2d`` and runs the int8 path. A block whose convs are int8
sites runs them one by one (the fused kernel takes float weights) and has
no packed weights; the heads stay float. Calibration
(``layers._calib_recorder`` set) runs each float identity block as the
fused kernel's training forward (``fused_bottleneck_emit``), which also
returns conv2's and conv3's inputs, so the recorder sees each conv's
input, as the JAX package's ``conv_site``, from the kernel the card
serves. ``DeepLabV2.drop_fused_conv_weights`` frees the conv kernels that
the identity blocks' packed copies replace (the serving export).

Spatial partitioning (``forward(x, space=..., in_h=...)``; the JAX
package's ``--sp``): ``x`` holds this rank's rows of an input of ``in_h``
rows and every map is split by rows over the space group
(``parallel/spatial.py``). Each op that reads H takes the window its
own output rows read, fetched from the ranks that own it and padded only
where it passes the global border, and runs with H padding 0: the stem's
7x7/2 (``_sp_conv``), the ceil-mode pool (padded with -inf, ``_sp_pool``),
the non-fusable blocks' convs (``Bottleneck.forward_sp``), and the heads
(the eval form exchanges its 36 x nc tap products, not the input). An
identity block runs the fused kernel on its input over ``[o0 - d, o1 +
d)`` clipped to the image, so the kernel's own zero padding falls only on
the global border, and keeps rows ``[o0, o1)``: the kernel is the same;
the halo rows are computed twice. W stays whole. With grad (a train step
inside ``spatial.training``) the same forward trains: the fetches carry
their gradients back to the rows' owners, an identity block runs
``FusedBottleneckFn`` (the emit kernel and ``bottleneck_backward``) on
its window, whose discarded halo rows get a zero gradient, and each weight
gradient is this rank's rows' share. A rank that owns no rows of a map
launches nothing for it (``spatial.no_rows``). Canvas masks
(``--concat_batches``) split by rows like any map: each op multiplies its
own rows by the mask's, so the windows it fetches are masked, and an
identity block's valid extents count rows from its window's first
(``_mask_rows``). Stage remat checkpoints each stage's loop of blocks
inside ``spatial.remat_region``, so the recompute replays the rows the
first forward received. int8 does not compose with it, as in the JAX
package.
"""

from __future__ import annotations

import copy
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
    fused_bottleneck_emit,
    fused_bottleneck_emit_reference,
    fused_bottleneck_reference,
    valid_mask,
)
from maxsquareloss_torch.models import layers
from maxsquareloss_torch.models.layers import (
    Conv2d,
    FrozenBN,
    QConv2d,
    aspp_matmul_forward,
    aspp_products,
    aspp_tap_sum,
    classifier_normal_,
    kaiming_normal_,
    max_pool_ceil,
)
from maxsquareloss_torch.parallel import spatial
from maxsquareloss_torch.parallel.spatial import SpaceGroup
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


def _mask_rows(mask: CanvasMask | None, r0: int, r1: int) -> CanvasMask | None:
    """``mask`` on rows ``[r0, r1)`` of its map: the 0/1 mask's rows, and
    each image's valid rows counted from ``r0`` and clamped to the window
    (its valid columns unchanged)."""
    if mask is None:
        return None
    rows = (mask.valid[:, :1] - r0).clamp(0, r1 - r0)
    return CanvasMask(mask.mask[:, :, r0:r1],
                      torch.cat([rows, mask.valid[:, 1:]], dim=1).contiguous())


@dataclasses.dataclass(frozen=True)
class DeepLabV2Config:
    num_classes: int = 19
    multi_level: bool = True
    blocks: tuple[int, ...] = RESNET101_BLOCKS
    compute_dtype: torch.dtype = torch.float32
    # '' | 'stages': checkpoint each ResNet stage (activations recomputed in
    # the backward instead of held)
    remat: str = ""
    # the ASPP heads' eval form (Classifier); the evaluator, predict,
    # calibration and the export run it, the train steps the training form
    aspp_matmul: bool = False


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          dilation: int = 1, bias: bool = False) -> nn.Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, bias=bias)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """The channels_last NCHW view of a contiguous NHWC tensor."""
    return t.permute(0, 3, 1, 2)


def _sp_input(y: torch.Tensor, h_in: int, h_out: int, space: SpaceGroup, k: int, s: int = 1,
              p: int = 0, d: int = 1, pad_value: float | None = 0.0) -> torch.Tensor:
    """The rows an H-reading op (k, s, p, d along H) reads for this rank's
    rows of its ``h_out``-row output, from ``y`` (this rank's rows of an
    (N, C, h_in, W) map), padded with ``pad_value`` where the window passes
    the border (None: clipped): channels_last NCHW. Collective."""
    need = space.windows(h_out, k, s, p, d)
    return _nchw(spatial.fetch_window(_nhwc(y), h_in, need, space, pad_value))


def _sp_conv(conv: Conv2d, y: torch.Tensor, h_in: int, space: SpaceGroup):
    """``conv`` on this rank's rows of a map of ``h_in`` rows: (its rows of
    the output, the output's height)."""
    if not isinstance(conv, Conv2d):
        raise NotImplementedError("--sp takes float convs; int8 does not compose with --sp")
    (k, kw), (s, sw), (p, pw), (d, dw) = conv.kernel_size, conv.stride, conv.padding, conv.dilation
    h_out = (h_in + 2 * p - d * (k - 1) - 1) // s + 1
    win = _sp_input(y, h_in, h_out, space, k, s, p, d)
    if win.shape[2] == 0:
        w_out = (y.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        return spatial.no_rows((y.shape[0], conv.out_channels, 0, w_out), y, y, conv.weight,
                               conv.bias), h_out
    return conv(win, pad_h=0), h_out


def _sp_pool(y: torch.Tensor, h_in: int, space: SpaceGroup):
    """The stem's ceil-mode 3x3/2 p1 maxpool on this rank's rows: the
    window padded with -inf (the pool's own padding) where it passes the
    border, the last window past the bottom edge included."""
    h_out = math.ceil((h_in + 2 - 3) / 2) + 1
    win = _sp_input(y, h_in, h_out, space, 3, 2, 1, 1, pad_value=-math.inf)
    if win.shape[2] == 0:
        w_out = math.ceil((y.shape[3] + 2 - 3) / 2) + 1
        return spatial.no_rows((y.shape[0], y.shape[1], 0, w_out), y, y), h_out
    return F.max_pool2d(win, 3, stride=2, padding=(0, 1), ceil_mode=True), h_out


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

    @property
    def quantized(self) -> bool:
        """Its convs are int8 sites (``models/quantize.py``)."""
        return isinstance(self.conv1, QConv2d)

    @torch.no_grad()
    def pack_weights(self, dtype: torch.dtype) -> None:
        for i, conv in enumerate((self.conv1, self.conv2, self.conv3), 1):
            if self.quantized:  # int8 sites run one by one: nothing to pack
                setattr(self, f"w{i}_hwio", None)
                continue
            w = conv.weight
            hwio = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).to(dtype)
            hwio = hwio.contiguous()  # a 1x1 kernel's permuted reshape is a view
            setattr(self, f"w{i}_hwio", hwio)

    def _hwio(self, i: int) -> torch.Tensor:
        conv = getattr(self, f"conv{i}")  # its weight may be dropped
        return getattr(self, f"w{i}_hwio").view(*conv.kernel_size, conv.in_channels,
                                                conv.out_channels)

    def forward(self, x: torch.Tensor, kernel, train_kernel,
                mask: CanvasMask | None = None) -> torch.Tensor:
        """``kernel`` (no grad, packed HWIO weights in the compute dtype)
        and ``train_kernel`` (grad enabled, fp32 HWIO views of
        ``conv{i}.weight``, cast by the kernel's Function or plain version):
        the fused bottleneck or its plain version, for the identity blocks,
        which take ``mask``'s valid extents; the others run as cuDNN convs
        and multiply h1 by ``mask``'s 0/1 mask before conv2."""
        valid = None if mask is None else mask.valid
        if self.fusable and not self.quantized:
            bn = (self.bn1.scale, self.bn1.bias, self.bn2.scale, self.bn2.bias,
                  self.bn3.scale, self.bn3.bias)
            if layers._calib_recorder is not None:
                # calibration: the training forward also returns h1 and h2,
                # the inputs of conv2 and conv3
                emit = (fused_bottleneck_emit_reference if kernel is fused_bottleneck_reference
                        else fused_bottleneck_emit)
                out, h1, h2 = emit(x, self._hwio(1), self._hwio(2), self._hwio(3), *bn,
                                   self.dilation, valid)
                for conv, t in ((self.conv1, x), (self.conv2, h1), (self.conv3, h2)):
                    layers._calib_recorder(conv, t)
                return out
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

    def forward_sp(self, x: torch.Tensor, h: int, space: SpaceGroup, kernel, train_kernel,
                   mask: CanvasMask | None = None):
        """The block on this rank's rows of a map of ``h`` rows: (its rows of
        the output, the output's height). An identity block runs ``forward``
        (the fused kernel) on the rows [o0 - d, o1 + d) clipped to the map,
        with ``mask``'s valid extents counted from the window's first row,
        and keeps [o0, o1); the others run their convs by ``_sp_conv`` and
        multiply their rows of h1 by ``mask``'s (the whole canvas's mask at
        h1's resolution)."""
        if self.fusable and not self.quantized:
            d = self.dilation
            o0, o1 = space.own(h)
            xw = _sp_input(x, h, h, space, 3, 1, d, d, pad_value=None)
            if o1 <= o0:
                return spatial.no_rows(tuple(x.shape), x, x, self.conv1.weight,
                                       self.conv2.weight, self.conv3.weight), h
            a = max(o0 - d, 0)
            out = self.forward(xw, kernel, train_kernel, _mask_rows(mask, a, a + xw.shape[2]))
            return out[:, :, o0 - a: o1 - a], h
        y, h_out = _sp_conv(self.conv1, x, h, space)
        y = F.relu(self.bn1(y))
        if mask is not None:
            y = y * _mask_rows(mask, *space.own(h_out)).mask.to(y.dtype)
        y = F.relu(self.bn2(_sp_conv(self.conv2, y, h_out, space)[0]))
        y = self.bn3(_sp_conv(self.conv3, y, h_out, space)[0])
        if self.downsample is None:
            residual = x
        else:
            residual = self.downsample[1](_sp_conv(self.downsample[0], x, h, space)[0])
        return F.relu(y + residual), h_out


class Classifier(nn.Module):
    """V2-style ASPP: four parallel dilated 3x3 convs. The training form
    sums their outputs in x's dtype; the eval form (``aspp_matmul``, the JAX
    package's ``aspp_sum`` forward) computes the 36 taps' products in x's
    dtype and sums them in float32 (``layers.aspp_matmul_forward``). In
    float32 the two are one sum in two orders."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            _conv(in_ch, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in ASPP_DILATIONS
        )

    def forward(self, x: torch.Tensor, mask: CanvasMask | None = None,
                aspp_matmul: bool = False) -> torch.Tensor:
        if mask is not None:
            x = x * mask.mask.to(x.dtype)
        if aspp_matmul:
            convs = self.conv2d_list
            return aspp_matmul_forward(x, [c.weight for c in convs], [c.bias for c in convs],
                                       ASPP_DILATIONS)
        out = None
        for conv in self.conv2d_list:
            y = conv(x)
            out = y if out is None else out + y
        return out

    def forward_sp(self, x: torch.Tensor, h: int, space: SpaceGroup,
                   aspp_matmul: bool = False, mask: CanvasMask | None = None) -> torch.Tensor:
        """The head on this rank's rows of a map of ``h`` rows (masked by
        its rows of ``mask``). The eval form computes its tap products on
        its own rows and fetches theirs within max(dilation) rows (36 x nc
        channels, not x's); the training form fetches x's rows and runs each
        conv on its part of the window."""
        if mask is not None:
            x = x * _mask_rows(mask, *space.own(h)).mask.to(x.dtype)
        pad = max(ASPP_DILATIONS)
        n_own = space.own(h)[1] - space.own(h)[0]
        convs = self.conv2d_list
        if aspp_matmul:
            z = aspp_products(x, [c.weight for c in convs])
            zh = spatial.fetch_window(z, h, space.windows(h, 3, 1, pad, pad), space)
            if n_own == 0:
                return spatial.no_rows((x.shape[0], convs[0].out_channels, 0, x.shape[3]),
                                       x, z).float()
            zp = F.pad(zh, (0, 0, pad, pad))
            return aspp_tap_sum(zp, [c.bias for c in convs], ASPP_DILATIONS, n_own)
        xw = _sp_input(x, h, h, space, 3, 1, pad, pad)
        if n_own == 0:
            return spatial.no_rows((x.shape[0], convs[0].out_channels, 0, x.shape[3]), x, x,
                                   *(p for c in convs for p in (c.weight, c.bias)))
        out = None
        for conv, d in zip(convs, ASPP_DILATIONS):
            y = conv(xw[:, :, pad - d: pad + d + n_own], pad_h=0)
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

    @property
    def quantized(self) -> bool:
        """Its backbone convs are int8 sites (``models/quantize.py``)."""
        return isinstance(self.conv1, QConv2d)

    def pack_weights(self) -> None:
        """Refresh the eval kernel's HWIO weights (in the compute dtype)
        from the convs (none for int8 blocks)."""
        for m in self.modules():
            if isinstance(m, Bottleneck) and m.fusable:
                m.pack_weights(self.cfg.compute_dtype)

    @torch.no_grad()
    def drop_fused_conv_weights(self) -> None:
        """Free each float identity block's conv kernels, which its packed
        HWIO copies replace on the eval path: a model that only serves then
        holds (and an export embeds) one copy of them. It can no longer
        train, repack or quantize."""
        for m in self.modules():
            if isinstance(m, Bottleneck) and m.fusable and not m.quantized:
                for conv in (m.conv1, m.conv2, m.conv3):
                    conv.weight = None

    def forward(self, x: torch.Tensor, aux: bool = True,
                masks: dict[str, CanvasMask] | None = None,
                space: SpaceGroup | None = None, in_h: int | None = None):
        """(N, H, W, 3) normalized images → (aux_or_None, main), each
        (N, H/8, W/8, num_classes) float32 in either compute dtype.
        ``aux=False`` skips the layer5 head (the eval/predict path reads only
        the main head); the heads' form is ``cfg.aspp_matmul``'s. ``masks``
        (``make_canvas_masks``): a canvas batch
        whose pad region is re-zeroed before the maxpool (``pool_in``), before every block's 3x3 (``os4``
        in layer1, ``os8`` in layers 2-4) and before both heads (``os8``).
        ``space``: a spatially partitioned forward, eval or (inside
        ``spatial.training``) training (the module docstring): ``x`` is
        this rank's rows of an input of ``in_h`` rows, and the logits are
        its rows of the global logits (``valid_logits_hw``)."""
        if space is not None:
            return self._forward_sp(x, aux, masks, space, in_h)
        m = masks or {}
        aspp_matmul = self.cfg.aspp_matmul
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
            self.layer5(y3, m.get("os8"), aspp_matmul) if aux and self.cfg.multi_level else None
        )
        main = self.layer6(self._stage(self.layer4, y3, m.get("os8")), m.get("os8"), aspp_matmul)

        def nhwc(t):
            return t.permute(0, 2, 3, 1).float()

        return (None if aux_out is None else nhwc(aux_out)), nhwc(main)

    def _stage_sp(self, layer: nn.Sequential, y: torch.Tensor, h: int, space: SpaceGroup,
                  mask: CanvasMask | None) -> tuple[torch.Tensor, int]:
        def run(y):
            h_out = h
            for block in layer:
                y, h_out = block.forward_sp(y, h_out, space, self.block_fn, self.train_block_fn,
                                            mask)
            heights.append(h_out)
            return y

        heights = []
        if self.cfg.remat == "stages" and torch.is_grad_enabled():
            log = spatial.RowLog()

            def region(y):
                with spatial.remat_region(space, log):
                    return run(y)

            y = torch.utils.checkpoint.checkpoint(region, y, use_reentrant=False,
                                                  preserve_rng_state=False)
            return y, heights[0]
        return run(y), heights[0]

    def _forward_sp(self, x: torch.Tensor, aux: bool, masks, space: SpaceGroup,
                    in_h: int | None):
        if in_h is None:
            raise ValueError("a spatially partitioned forward needs the input's height in_h")
        if self.quantized:
            raise NotImplementedError("--quantize int8 does not compose with --sp")
        m = masks or {}
        aspp_matmul = self.cfg.aspp_matmul
        y = x.to(self.cfg.compute_dtype).permute(0, 3, 1, 2)
        y = y.contiguous(memory_format=torch.channels_last)
        y, h = _sp_conv(self.conv1, y, in_h, space)
        y = F.relu(self.bn1(y))
        if masks is not None:
            y = y * _mask_rows(m["pool_in"], *space.own(h)).mask.to(y.dtype)
        y, h = _sp_pool(y, h, space)
        y, h = self._stage_sp(self.layer1, y, h, space, m.get("os4"))
        y, h = self._stage_sp(self.layer2, y, h, space, m.get("os8"))
        y3, h = self._stage_sp(self.layer3, y, h, space, m.get("os8"))
        aux_out = (self.layer5.forward_sp(y3, h, space, aspp_matmul, m.get("os8"))
                   if aux and self.cfg.multi_level else None)
        main = self.layer6.forward_sp(self._stage_sp(self.layer4, y3, h, space, m.get("os8"))[0],
                                      h, space, aspp_matmul, m.get("os8"))

        def nhwc(t):
            return t.permute(0, 2, 3, 1).float()

        return (None if aux_out is None else nhwc(aux_out)), nhwc(main)


def eval_form(model: DeepLabV2) -> DeepLabV2:
    """``model`` with the heads' eval form (``cfg.aspp_matmul``), as the JAX
    evaluator's ``model_config(cfg, eval_mode=True)`` over the same params:
    the model itself when it has that form, else a shallow copy that shares
    every parameter, buffer and submodule and differs only in ``cfg``."""
    if model.cfg.aspp_matmul:
        return model
    view = copy.copy(model)
    view.cfg = dataclasses.replace(model.cfg, aspp_matmul=True)
    return view


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
