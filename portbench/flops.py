"""Operations and bytes of DeepLabV2-ResNet101's work, counted from shapes.

- ``forward_convs``: every conv of one forward, with its output pixels.
- Model FLOPs: 2 * pixels * Cin * Cout * k^2 a conv (a multiply-add is
  two operations); a training step counts the forward, the gradient of the
  input (not for the stem, whose input is the image) and the gradient of the
  weight, once each and without recompute.
- ``identity_block_work``: (FLOP, bytes) of one launch of the fused
  bottleneck over a stride-1 identity block (``chip_smoke.py``'s
  ``_block_work``): conv1, conv2 and conv3; the input read and the output
  written once, h1 and h2 written once more by the training forward
  (``emit``), the weights read once, in elements of ``itemsize`` bytes, and
  the six BN vectors in float32.
- ``iw_loss_work``: (FLOP, bytes) of the fused IW max-squares loss, forward
  and backward, on float32 logits of m = N*H*W*C elements
  (``chip_smoke.py``'s loss lines): forward 10 m FLOP and 4 m + 4 N C + 4
  bytes, backward 14 m FLOP and 8 m + 4 N C + 4 bytes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

PLANES = (64, 128, 256, 512)
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
EXPANSION = 4
ASPP_TAPS = 4


class Conv(NamedTuple):
    name: str
    pixels: int  # output pixels over the batch
    cin: int
    cout: int
    k: int

    @property
    def flops(self) -> int:
        return 2 * self.pixels * self.cin * self.cout * self.k * self.k


class Block(NamedTuple):
    """One identity block: the fused kernel's launch shape."""

    n: int
    h: int
    w: int
    cin: int
    cmid: int
    dilation: int


def stem_hw(hw: tuple[int, int]) -> dict[str, tuple[int, int]]:
    """Map sizes: after the 7x7/2 conv, after the ceil-mode 3x3/2 pool
    (output stride 4), after layer2's stride (output stride 8)."""
    def conv1(v):
        return (v + 2 * 3 - 7) // 2 + 1

    def pool(v):
        out = math.ceil((v + 2 * 1 - 3) / 2) + 1
        return out - 1 if (out - 1) * 2 >= v + 1 else out

    h1, w1 = conv1(hw[0]), conv1(hw[1])
    h2, w2 = pool(h1), pool(w1)
    return {"stem": (h1, w1), "os4": (h2, w2), "os8": ((h2 - 1) // 2 + 1, (w2 - 1) // 2 + 1)}


def forward_convs(blocks, num_classes: int, n: int, hw, aux: bool = True) -> list[Conv]:
    """Every conv of a forward of ``n`` images of ``hw`` (H, W)."""
    sizes = stem_hw(hw)
    px = {k: n * h * w for k, (h, w) in sizes.items()}
    convs = [Conv("stem", px["stem"], 3, 64, 7)]
    in_ch = 64
    for s, nb in enumerate(blocks):
        planes, out = PLANES[s], PLANES[s] * EXPANSION
        for b in range(nb):
            # the stride sits on the first block's conv1: its output is at the
            # stage's size, and so is everything after it
            p = px["os4"] if s == 0 else px["os8"]
            down = b == 0 and (STRIDES[s] != 1 or in_ch != out or DILATIONS[s] in (2, 4))
            kind = "identity" if not down else "downsample_block"
            convs += [Conv(f"{kind}.conv1", p, in_ch, planes, 1),
                      Conv(f"{kind}.conv2", p, planes, planes, 3),
                      Conv(f"{kind}.conv3", p, planes, out, 1)]
            if down:
                convs.append(Conv("downsample", p, in_ch, out, 1))
            in_ch = out
    heads = [("layer5", 1024)] if aux else []
    heads.append(("layer6", 2048))
    for name, cin in heads:
        convs += [Conv(f"{name}.aspp", px["os8"], cin, num_classes, 3)] * ASPP_TAPS
    return convs


def forward_flops(blocks, num_classes, n, hw, aux=True) -> int:
    return sum(c.flops for c in forward_convs(blocks, num_classes, n, hw, aux))


def train_flops(blocks, num_classes, n, hw) -> int:
    """Forward, input gradient and weight gradient of every conv of one
    forward (both heads); the stem takes no input gradient."""
    return sum(c.flops * (2 if c.name == "stem" else 3)
               for c in forward_convs(blocks, num_classes, n, hw, aux=True))


def uda_step_flops(blocks, num_classes, n_source, source_hw, n_target, target_hw) -> int:
    return (train_flops(blocks, num_classes, n_source, source_hw)
            + train_flops(blocks, num_classes, n_target, target_hw))


def tta_flops(blocks, num_classes, n, hw, scales, flip: bool) -> int:
    """The main head's forwards of one evaluation under test-time scales
    (``round(H * s)``) and the flip."""
    views = 2 if flip else 1
    return sum(views * forward_flops(blocks, num_classes, n,
                                     (max(1, round(hw[0] * s)), max(1, round(hw[1] * s))),
                                     aux=False) for s in scales)


def identity_blocks(blocks, n: int, hw) -> list[Block]:
    """The identity blocks of one forward, as the fused kernel's launches."""
    sizes = stem_hw(hw)
    out = []
    in_ch = 64
    for s, nb in enumerate(blocks):
        planes = PLANES[s]
        h, w = sizes["os4"] if s == 0 else sizes["os8"]
        for b in range(nb):
            down = b == 0 and (STRIDES[s] != 1 or in_ch != planes * EXPANSION
                               or DILATIONS[s] in (2, 4))
            if not down:
                out.append(Block(n, h, w, in_ch, planes, DILATIONS[s]))
            in_ch = planes * EXPANSION
    return out


def identity_block_work(b: Block, emit: bool, itemsize: int) -> tuple[int, int]:
    px = b.n * b.h * b.w
    flops = 2 * px * (2 * b.cin * b.cmid + 9 * b.cmid * b.cmid)
    nbytes = (itemsize * (2 * px * (b.cin + (b.cmid if emit else 0)) + 2 * b.cin * b.cmid
                          + 9 * b.cmid * b.cmid) + 4 * (4 * b.cmid + 2 * b.cin))
    return flops, nbytes


def iw_loss_work(n: int, h: int, w: int, c: int) -> list[tuple[int, int]]:
    """The forward's and the backward's (FLOP, bytes)."""
    m = n * h * w * c
    return [(10 * m, 4 * m + 4 * n * c + 4), (14 * m, 8 * m + 4 * n * c + 4)]


def bound_seconds(work: list[tuple[int, int]], peak_flops: float, peak_bytes: float) -> float:
    """The least time of a list of launches: each launch the larger of its
    operations over the peak rate and its bytes over the memory bandwidth."""
    return sum(max(f / peak_flops, b / peak_bytes) for f, b in work)
