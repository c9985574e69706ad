"""Configuration of the port's eval/predict path.

A subset of ``maxsquareloss_tpu/config.py`` ``TrainConfig``: the fields the
forward/serving path reads, under the same names and defaults. The path
computes in float32 (the fused bottleneck kernel takes float32 only); the
argparse shims come with the CLIs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model
    num_classes: int = 19
    blocks: tuple[int, ...] = (3, 4, 23, 3)  # ResNet-101; tests shrink this
    multi: bool = True                 # multi-level (aux head layer5)
    # data
    numpy_transform: bool = True       # caffe BGR − IMG_MEAN (protocol default)
    # stream the eval upsample→softmax→argmax→CM tail over N output rows at
    # a time (exact: row-local interpolation); -1 = auto (256-row chunks
    # whenever the label height exceeds 512), 0 = off
    eval_h_chunk: int = -1
