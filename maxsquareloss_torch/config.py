"""Configuration of the port's eval/predict and training paths.

A subset of ``maxsquareloss_tpu/config.py`` ``TrainConfig``: the fields the
forward/serving path and the train steps read, under the same names and
defaults. The paths compute in float32 (the fused kernels take float32
only); the argparse shims come with the CLIs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model
    num_classes: int = 19
    blocks: tuple[int, ...] = (3, 4, 23, 3)  # ResNet-101; tests shrink this
    multi: bool = True                 # multi-level (aux head layer5)

    # optimizer (reference defaults: SGD 2.5e-4, momentum .9, wd 5e-4)
    lr: float = 2.5e-4
    momentum: float = 0.9
    weight_decay: float = 5e-4
    iter_max: int = 200000
    poly_power: float = 0.9

    # supervised / source loss: the aux head's CE weight
    lambda_seg: float = 0.1

    # UDA target loss
    # 'maxsquare' | 'IW_maxsquare' | 'entropy' | 'IW_entropy' | 'hard'
    target_mode: str = "IW_maxsquare"
    lambda_target: float = 0.09
    ratio: float = 0.2                 # --IW_ratio
    threshold: float = 0.95            # guidance confidence threshold
    guidance_mask: str = "ensemble"    # 'ensemble' | 'per_head_or'
    # histogram of the IW weights under --multi: 'guidance' counts the
    # thresholded pseudo-label (reference parity; a class none of whose
    # pixels clears --threshold gets the degenerate weight 1.0), 'argmax'
    # the unthresholded prediction (the single-head behaviour)
    iw_hist: str = "guidance"          # 'guidance' | 'argmax'

    # data: (W, H) sizes as in the reference flags
    batch_size: int = 4
    crop_size: tuple[int, int] = (1280, 640)
    target_crop_size: tuple[int, int] = (1024, 512)
    numpy_transform: bool = True       # caffe BGR − IMG_MEAN (protocol default)
    # stream the eval upsample→softmax→argmax→CM tail over N output rows at
    # a time (exact: row-local interpolation); -1 = auto (256-row chunks
    # whenever the label height exceeds 512), 0 = off
    eval_h_chunk: int = -1
