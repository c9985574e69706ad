"""Cityscapes dataset and the shared dataset base class (the port's own copy
of ``maxsquareloss_tpu/data/cityscapes.py``).

Split list files of ``leftImg8bit`` image paths with ``gtFine`` labelId
PNGs, the 19-class id → trainId remap (unmapped → -1), the paired train/val
transforms, both normalizations, and the ``class_16``/``class_13`` label
filters of the SYNTHIA / cross-city protocols. For the same ``(index,
rng)`` a sample is bitwise the JAX package's: this is its general path
(PIL decode and resize, raw ``.npy`` sidecars, the base-size cache), which
the JAX package's native fast paths reproduce exactly. The port's own
native build of those paths is later work. Host-side only; PIL is imported
where a file is decoded.
"""

from __future__ import annotations

import hashlib
import os
from typing import Sequence

import numpy as np

from maxsquareloss_torch.data.transforms import (
    IGNORE_LABEL,
    TransformConfig,
    img_transform,
    mask_transform,
    remap_lut,
    train_sync_transform,
    val_sync_transform,
)

# 19-class Cityscapes labelId → trainId
CITYSCAPES_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

# trainId subsets for the SYNTHIA (16) and cross-city (13) protocols:
# classes NOT in the subset are mapped to ignore when class_16/class_13 is set.
TRAINID_SET_16 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 15, 17, 18]
TRAINID_SET_13 = [0, 1, 2, 6, 7, 8, 10, 11, 12, 13, 15, 17, 18]


def _raw_path(path: str) -> str:
    """Raw-format sidecar of a dataset file: ``<path>.npy`` holding the
    decoded pixels at base_size (``tools/prepare_dataset.py --format raw``)."""
    return path + ".npy"


def _subset_filter_lut(keep: Sequence[int], relabel: bool) -> np.ndarray:
    """LUT over trainIds (+1 shifted for the -1 ignore slot).

    relabel=True compacts kept classes to 0..len(keep)-1 (the 13-class
    cross-city head); relabel=False keeps the trainIds and ignores the rest
    (16-class SYNTHIA eval on a 19-class head).
    """
    lut = np.full((20,), IGNORE_LABEL, dtype=np.int32)  # index = trainid + 1
    for new, tid in enumerate(sorted(keep)):
        lut[tid + 1] = new if relabel else tid
    return lut


def _label_image(arr: np.ndarray):
    """A PIL image of raw label ids: uint8 as 'L', wider ids as 'I'."""
    from PIL import Image

    if arr.dtype != np.uint8:
        return Image.fromarray(arr.astype(np.int32), mode="I")
    return Image.fromarray(arr)


class SegDataset:
    """Shared base: list-file driven paired (image, label) dataset.

    Subclasses set ``id_to_trainid`` and may override ``_pair_paths`` /
    ``_decode_mask``. List files hold one relative image path per line, or
    an explicit "image_path label_path" pair.
    """

    id_to_trainid: dict[int, int] = CITYSCAPES_ID_TO_TRAINID

    def __init__(
        self,
        root: str,
        list_path: str,
        split: str = "train",
        transform_cfg: TransformConfig | None = None,
        class_16: bool = False,
        class_13: bool = False,
        relabel_13: bool = False,
        full_res_labels: bool = False,
        cache_dir: str | None = None,
    ):
        self.root = root
        self.split = split
        self.cfg = transform_cfg or TransformConfig()
        self.training = split == "train"
        self.full_res_labels = full_res_labels
        # decoded-sample cache: (image, raw mask) at base_size as .npz
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self.lut = remap_lut(self.id_to_trainid)
        self.class_filter = None
        if class_13:
            self.class_filter = _subset_filter_lut(TRAINID_SET_13, relabel_13)
        elif class_16:
            self.class_filter = _subset_filter_lut(TRAINID_SET_16, relabel=False)
        with open(list_path) as f:
            self.items = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.items)

    # -- path resolution -------------------------------------------------

    def _pair_paths(self, item: str) -> tuple[str, str]:
        if " " in item:
            img_rel, lab_rel = item.split()[:2]
            return os.path.join(self.root, img_rel), os.path.join(self.root, lab_rel)
        img_rel = item
        lab_rel = img_rel.replace("leftImg8bit", "gtFine", 1).replace(
            "_leftImg8bit.png", "_gtFine_labelIds.png"
        )
        return os.path.join(self.root, img_rel), os.path.join(self.root, lab_rel)

    # -- raw loading -----------------------------------------------------

    def _load_image(self, path: str):
        from PIL import Image

        if os.path.exists(_raw_path(path)):  # raw-prepared root: no decode
            return Image.fromarray(np.load(_raw_path(path)))
        return Image.open(path).convert("RGB")

    def _load_mask(self, path: str):
        """→ PIL image of RAW label ids (remapped late, in get())."""
        if os.path.exists(_raw_path(path)):  # raw-prepared root: no decode
            return _label_image(np.load(_raw_path(path)))
        return self._decode_mask(path)

    def _decode_mask(self, path: str):
        from PIL import Image

        return Image.open(path)

    # -- sample assembly -------------------------------------------------

    def _load_pair(self, index: int):
        """(image, mask) PIL pair, through the base-size cache when enabled."""
        from PIL import Image

        img_path, lab_path = self._pair_paths(self.items[index])
        if self.cache_dir is None or (not self.training and self.full_res_labels):
            return self._load_image(img_path), self._load_mask(lab_path)
        w, h = self.cfg.base_size
        # keyed on the resolved paths: an edited split list reusing the same
        # cache_dir must not serve stale pairs
        digest = hashlib.sha1(f"{img_path}\0{lab_path}".encode()).hexdigest()[:12]
        path = os.path.join(self.cache_dir, f"{index:06d}_{digest}_{w}x{h}.npz")
        if os.path.exists(path):
            z = np.load(path)
            return Image.fromarray(z["img"]), _label_image(z["mask"])
        img = self._load_image(img_path).resize(self.cfg.base_size, Image.BICUBIC)
        mask = self._load_mask(lab_path).resize(self.cfg.base_size, Image.NEAREST)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, img=np.asarray(img), mask=np.asarray(mask))
        os.replace(tmp, path)
        return img, mask

    def get(self, index: int, rng: np.random.Generator):
        """→ (image (H,W,3) float32 or uint8, label (H,W) int32 or int8, name)."""
        img_path, _ = self._pair_paths(self.items[index])
        img, mask = self._load_pair(index)
        if self.training:
            img, mask = train_sync_transform(img, mask, self.cfg, rng)
        else:
            img, mask = val_sync_transform(img, mask, self.cfg,
                                           full_res_labels=self.full_res_labels)
        if self.cfg.device_normalize:
            # raw uint8 RGB to the device; the step normalizes there
            x = np.asarray(img, dtype=np.uint8)
        else:
            x = img_transform(img, self.cfg.numpy_transform)
        y = mask_transform(mask, self.lut)
        if self.class_filter is not None:
            y = self.class_filter[np.clip(y + 1, 0, 19)]
        if self.cfg.device_normalize:
            y = y.astype(np.int8)  # trainIds -1..18 fit; widened on the device
        name = os.path.splitext(os.path.basename(img_path))[0]
        return x, y, name


class CityscapesDataset(SegDataset):
    """Cityscapes leftImg8bit/gtFine (labeled val / unlabeled UDA target)."""

    id_to_trainid = CITYSCAPES_ID_TO_TRAINID
