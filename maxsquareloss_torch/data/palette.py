"""Cityscapes label palette and input-normalization constants.

The port's own copy of ``maxsquareloss_tpu/data/palette.py`` (host-side
numpy, same values): ``LABEL_COLOURS``, the caffe ``IMG_MEAN`` and the
torchvision ``IMAGENET_MEAN/STD``, and ``decode_labels``.
"""

from __future__ import annotations

import numpy as np

# Official Cityscapes trainId palette (19 classes), RGB.
LABEL_COLOURS = [
    (128, 64, 128),   # road
    (244, 35, 232),   # sidewalk
    (70, 70, 70),     # building
    (102, 102, 156),  # wall
    (190, 153, 153),  # fence
    (153, 153, 153),  # pole
    (250, 170, 30),   # traffic light
    (220, 220, 0),    # traffic sign
    (107, 142, 35),   # vegetation
    (152, 251, 152),  # terrain
    (70, 130, 180),   # sky
    (220, 20, 60),    # person
    (255, 0, 0),      # rider
    (0, 0, 142),      # car
    (0, 0, 70),       # truck
    (0, 60, 100),     # bus
    (0, 80, 100),     # train
    (0, 0, 230),      # motorcycle
    (119, 11, 32),    # bicycle
]

# caffe-style BGR channel means used by the caffe-converted DeepLabV2 init
IMG_MEAN = np.array((104.00698793, 116.66876762, 122.67891434), dtype=np.float32)

IMAGENET_MEAN = np.array((0.485, 0.456, 0.406), dtype=np.float32)
IMAGENET_STD = np.array((0.229, 0.224, 0.225), dtype=np.float32)


def decode_labels(mask: np.ndarray, num_images: int | None = None) -> np.ndarray:
    """Colorize trainId masks → (N, H, W, 3) uint8 RGB; ignore (-1/255) → black.

    Accepts (H, W) or (N, H, W) int masks.
    """
    if mask.ndim == 2:
        mask = mask[None]
    if num_images is not None:
        mask = mask[:num_images]
    palette = np.zeros((256, 3), dtype=np.uint8)
    for i, c in enumerate(LABEL_COLOURS):
        palette[i] = c
    idx = np.where((mask >= 0) & (mask < len(LABEL_COLOURS)), mask, 255)
    return palette[idx.astype(np.int64) & 0xFF]
