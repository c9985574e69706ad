"""Host-side image/label transforms for the segmentation pipelines (the
port's own copy of ``maxsquareloss_tpu/data/transforms.py``).

Random h-flip, resize to base_size, optional random scale + crop to
crop_size, optional Gaussian blur; caffe (BGR − IMG_MEAN) or torchvision
(mean/std) normalization; label id → trainId through a LUT with unmapped →
-1. All randomness flows through an explicit ``np.random.Generator`` in the
JAX package's order of draws, so the same ``(seed, epoch, index)`` gives
the same sample bit for bit. PIL is imported inside the functions that
resize or blur, so a trainer over in-memory data runs without it. The blur
runs through the host extension's byte-exact copy of Pillow's where the
extension builds (``data/hostops.py``), through PIL otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from maxsquareloss_torch.data import hostops
from maxsquareloss_torch.data.palette import IMAGENET_MEAN, IMAGENET_STD, IMG_MEAN

IGNORE_LABEL = -1


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    base_size: tuple[int, int] = (1280, 720)   # (W, H) — PIL convention
    crop_size: tuple[int, int] = (1280, 640)   # (W, H)
    random_mirror: bool = True
    random_crop: bool = False
    scale_range: tuple[float, float] = (0.5, 1.5)
    gaussian_blur: bool = True
    blur_prob: float = 0.5
    numpy_transform: bool = True  # caffe normalization
    # ship uint8 images / int8 labels to the device and normalize there
    # (train/steps.py _prepare_inputs): the same float32 math
    device_normalize: bool = False


def remap_lut(id_to_trainid: dict[int, int], max_id: int = 256) -> np.ndarray:
    """Dense LUT: raw label id → trainId, unmapped ids → IGNORE_LABEL."""
    lut = np.full((max_id,), IGNORE_LABEL, dtype=np.int32)
    for k, v in id_to_trainid.items():
        if 0 <= k < max_id:
            lut[k] = v
    return lut


def mask_transform(mask, lut: np.ndarray) -> np.ndarray:
    """Label image (PIL or array) → remapped int32 (H, W) trainId mask."""
    arr = np.asarray(mask)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = np.clip(arr.astype(np.int64), 0, len(lut) - 1)
    return lut[arr]


def img_transform(img, numpy_transform: bool = True) -> np.ndarray:
    """RGB PIL image/array → normalized float32 (H, W, 3)."""
    arr = np.asarray(img, dtype=np.float32)
    if numpy_transform:
        # caffe path: RGB→BGR, subtract channel means, no std division
        bgr = arr[..., ::-1]
        return np.ascontiguousarray(bgr - IMG_MEAN)
    return (arr / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def _resize_pair(img, mask, size_wh: tuple[int, int]):
    from PIL import Image

    # identity resizes are skipped (cached samples arrive pre-resized)
    if img.size != size_wh:
        img = img.resize(size_wh, Image.BICUBIC)
    if mask.size != size_wh:
        mask = mask.resize(size_wh, Image.NEAREST)
    return img, mask


def train_sync_transform(img, mask, cfg: TransformConfig, rng: np.random.Generator):
    """Paired train-time augmentation of PIL images (before normalization)."""
    from PIL import Image

    if cfg.random_mirror and rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    # resize to base_size first, then optionally scale + crop
    img, mask = _resize_pair(img, mask, cfg.base_size)
    if cfg.random_crop:
        scale = rng.uniform(*cfg.scale_range)
        sw = max(int(round(cfg.base_size[0] * scale)), cfg.crop_size[0])
        sh = max(int(round(cfg.base_size[1] * scale)), cfg.crop_size[1])
        img, mask = _resize_pair(img, mask, (sw, sh))
        x0 = int(rng.integers(0, sw - cfg.crop_size[0] + 1))
        y0 = int(rng.integers(0, sh - cfg.crop_size[1] + 1))
        box = (x0, y0, x0 + cfg.crop_size[0], y0 + cfg.crop_size[1])
        img, mask = img.crop(box), mask.crop(box)
    if cfg.gaussian_blur and rng.random() < cfg.blur_prob:
        img = Image.fromarray(gaussian_blur(np.asarray(img), float(rng.random())))
    return img, mask


def gaussian_blur(arr: np.ndarray, radius: float) -> np.ndarray:
    """uint8 (H, W, 3) → Pillow's ``GaussianBlur(radius)`` of it: the host
    extension's blur where it builds, PIL's otherwise; the same bytes."""
    if hostops.available():
        return hostops.gaussian_blur(arr, radius)
    from PIL import Image, ImageFilter

    img = Image.fromarray(np.ascontiguousarray(arr))
    return np.asarray(img.filter(ImageFilter.GaussianBlur(radius=radius)))


def val_sync_transform(img, mask, cfg: TransformConfig, full_res_labels: bool = False):
    """Deterministic val resize; ``full_res_labels`` keeps the label at its
    native resolution."""
    from PIL import Image

    img = img.resize(cfg.base_size, Image.BICUBIC)
    if not full_res_labels:
        mask = mask.resize(cfg.base_size, Image.NEAREST)
    return img, mask
