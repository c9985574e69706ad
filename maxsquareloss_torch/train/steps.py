"""Step helpers of the port's forward path (counterparts of
``maxsquareloss_tpu/train/steps.py`` ``model_config``, ``_prepare_inputs``
and ``make_eval_step``). The train steps come with the training slice.
"""

from __future__ import annotations

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.data.palette import IMAGENET_MEAN, IMAGENET_STD, IMG_MEAN
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2Config


def model_config(cfg: TrainConfig) -> DeepLabV2Config:
    """The model's config from the run's."""
    return DeepLabV2Config(
        num_classes=cfg.num_classes,
        multi_level=cfg.multi,
        blocks=tuple(cfg.blocks),
    )


def _prepare_inputs(x: torch.Tensor | None, y: torch.Tensor | None, cfg: TrainConfig):
    """Normalize uint8 NHWC images on their device, widen labels to int64.

    The caffe path (``numpy_transform``, the protocol default) is BGR minus
    ``IMG_MEAN``, bitwise the host pipeline's float32 result; the
    torchvision path is ``(x/255 - mean) / std``. float inputs pass
    through untouched (already normalized).
    """
    if x is not None and x.dtype == torch.uint8:
        xf = x.float()
        if cfg.numpy_transform:
            x = xf.flip(-1) - torch.from_numpy(IMG_MEAN).to(x.device)
        else:
            mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
            std = torch.from_numpy(IMAGENET_STD).to(x.device)
            x = (xf / 255.0 - mean) / std
    if y is not None and y.dtype != torch.int64:
        y = y.long()
    return x, y


def make_eval_step(cfg: TrainConfig, model, num_eval_classes: int | None = None):
    """Validation step: forward → upsample to label size → argmax → CM
    partial; the multi-scale evaluator with the single scale-1.0 head."""
    from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step

    return make_multiscale_eval_step(
        cfg, model, scales=(1.0,), flip=False, num_eval_classes=num_eval_classes
    )
