"""Cityscapes dataset and the shared dataset base class (the port's own copy
of ``maxsquareloss_tpu/data/cityscapes.py``).

Split list files of ``leftImg8bit`` image paths with ``gtFine`` labelId
PNGs, the 19-class id → trainId remap (unmapped → -1), the paired train/val
transforms, both normalizations, and the ``class_16``/``class_13`` label
filters of the SYNTHIA / cross-city protocols. For the same ``(index,
rng)`` a sample is bitwise the JAX package's.

Routes of a sample, each giving the same bits:
  - raw-prepared roots (``.npy`` sidecars at base size): no decode at all;
  - PNGs at base size, not interlaced (an IHDR peek), with the host
    extension (``data/hostops.py``): one fused C++ pass a file (decode +
    normalize, decode + remap), the mirror a view, the blur the
    extension's copy of Pillow's; in training only without random crops;
  - otherwise the general path: decode (the extension's where it reads the
    file as PIL does, else PIL), PIL resize and augmentation, the base-size
    cache.
Palette label PNGs read as their indices on every route, as PIL reads them.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import NamedTuple, Sequence

import numpy as np

from maxsquareloss_torch.data import hostops
from maxsquareloss_torch.data.palette import IMG_MEAN
from maxsquareloss_torch.data.transforms import (
    IGNORE_LABEL,
    TransformConfig,
    gaussian_blur,
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


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


class PngHeader(NamedTuple):
    size: tuple[int, int]  # (W, H)
    depth: int
    color: int  # PNG colour type: 0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA
    interlaced: bool


def _png_header(head: bytes) -> PngHeader | None:
    """The IHDR fields of PNG data (its first 29 bytes are enough); None
    for other data."""
    if len(head) < 29 or head[:8] != _PNG_MAGIC or head[12:16] != b"IHDR":
        return None
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", head[16:29])
    return PngHeader((w, h), depth, color, interlace != 0)


def _peek_png(path: str) -> PngHeader | None:
    """The IHDR of a PNG file: 29 bytes read, no decode."""
    try:
        with open(path, "rb") as f:
            return _png_header(f.read(29))
    except OSError:
        return None


def _native_image(hdr: PngHeader) -> bool:
    """Whether the extension's RGB decode of such a file is PIL's
    ``convert("RGB")``: every kind but 16-bit gray, which PIL clips to 255
    where the extension keeps the high byte; interlaced files go to PIL."""
    return not hdr.interlaced and not (hdr.color == 0 and hdr.depth == 16)


def _native_bytes(path: str, eligible) -> bytes | None:
    """The bytes of a PNG file the extension decodes as the general path's
    decoder does (``eligible`` of its header); None where it does not."""
    if not path.endswith(".png") or not hostops.available():
        return None
    with open(path, "rb") as f:
        data = f.read()
    hdr = _png_header(data)
    return data if hdr is not None and eligible(hdr) else None


def _first_channel(arr: np.ndarray) -> np.ndarray:
    return arr[..., 0] if arr.ndim == 3 else arr


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
        data = _native_bytes(path, _native_image)
        if data is not None:
            return Image.fromarray(hostops.decode_png(data, True))
        return Image.open(path).convert("RGB")

    def _load_mask(self, path: str):
        """→ PIL image of RAW label ids (remapped late, in get())."""
        if os.path.exists(_raw_path(path)):  # raw-prepared root: no decode
            return _label_image(np.load(_raw_path(path)))
        return self._decode_mask(path)

    def _native_label(self, hdr: PngHeader) -> bool:
        """Whether the extension's stored samples of such a label file (its
        first channel) are the ids PIL reads: 8-bit files, palette indices,
        1- and 16-bit gray; not interlaced. PIL scales 2- and 4-bit gray and
        reads 16-bit colour as 8-bit."""
        return not hdr.interlaced and (hdr.depth == 8 or hdr.color == 3
                                       or (hdr.color == 0 and hdr.depth in (1, 16)))

    def _decode_mask(self, path: str):
        from PIL import Image

        data = _native_bytes(path, self._native_label)
        if data is not None:
            return _label_image(_first_channel(hostops.decode_png(data, False)))
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

    def _load_raw_pair(self, img_path: str, lab_path: str):
        """(uint8 HWC image, raw label ids) from raw-prepared ``.npy``
        sidecars at exactly base_size, or None. One open a file: on such a
        root the arrays loaded are the ones used."""
        try:
            img = np.load(_raw_path(img_path))
            ids = np.load(_raw_path(lab_path))
        except (OSError, ValueError):
            return None
        w, h = self.cfg.base_size
        if img.shape != (h, w, 3) or img.dtype != np.uint8 or ids.shape != (h, w):
            return None
        return img, ids

    def _base_size_pngs(self, img_path: str, lab_path: str):
        """(image bytes, label bytes) of a pair of PNGs at base_size that
        the extension decodes as the general path does, or None."""
        if not (hostops.available() and img_path.endswith(".png")
                and lab_path.endswith(".png")):
            return None
        size = tuple(self.cfg.base_size)
        img, lab = _peek_png(img_path), _peek_png(lab_path)
        if (img is None or lab is None or img.size != size or lab.size != size
                or not _native_image(img) or not self._native_label(lab)):
            return None
        with open(img_path, "rb") as f, open(lab_path, "rb") as g:
            return f.read(), g.read()

    def _normalize(self, x_u8: np.ndarray) -> np.ndarray:
        """uint8 RGB → what crosses to the device: itself (device_normalize)
        or normalized float32."""
        if self.cfg.device_normalize:
            return np.ascontiguousarray(x_u8)
        return img_transform(x_u8, self.cfg.numpy_transform)

    def _decode_image(self, data: bytes) -> np.ndarray:
        """Image PNG bytes → ``_normalize`` of its RGB; the caffe
        normalization fused into the decode."""
        if self.cfg.numpy_transform and not self.cfg.device_normalize:
            return hostops.decode_normalize_bgr(data, IMG_MEAN)
        return self._normalize(hostops.decode_png(data, True))

    def _fused_val_sample(self, img_path: str, lab_path: str):
        """At base size the val transform is the identity: the sample is the
        raw sidecars' pixels through the shared normalize and remap, or one
        fused decode pass a PNG. (x, y), or None for the general path."""
        if self.training or self.full_res_labels:
            return None
        pair = self._load_raw_pair(img_path, lab_path)
        if pair is not None:
            return self._normalize(pair[0]), mask_transform(pair[1], self.lut)
        pngs = self._base_size_pngs(img_path, lab_path)
        if pngs is None:
            return None
        return self._decode_image(pngs[0]), hostops.decode_remap(pngs[1], self.lut)

    def _fused_train_sample(self, img_path: str, lab_path: str, rng: np.random.Generator):
        """Training at base size without random crops: the resize is the
        identity, so the sample is the decode (or the raw sidecars), the
        mirror as a view and the blur. The draws are the general path's, in
        its order (mirror gate, blur gate, radius), so the stream is the
        same bits. Normalization and remap are per pixel and commute with
        the mirror; the blur keeps the general order (mirror, blur,
        normalize). (x, y), or None for the general path."""
        cfg = self.cfg
        if not self.training or cfg.random_crop:
            return None
        pair = self._load_raw_pair(img_path, lab_path)
        pngs = None if pair is not None else self._base_size_pngs(img_path, lab_path)
        if pair is None and pngs is None:
            return None
        flip = bool(cfg.random_mirror and rng.random() < 0.5)
        radius = (float(rng.random()) if cfg.gaussian_blur and rng.random() < cfg.blur_prob
                  else None)
        if pair is not None:
            x, y = pair[0], mask_transform(pair[1], self.lut)
        elif radius is None:  # normalized in the decode pass
            x, y = self._decode_image(pngs[0]), hostops.decode_remap(pngs[1], self.lut)
            x, y = (x[:, ::-1], y[:, ::-1]) if flip else (x, y)
            return np.ascontiguousarray(x), np.ascontiguousarray(y)
        else:
            x, y = hostops.decode_png(pngs[0], True), hostops.decode_remap(pngs[1], self.lut)
        if flip:
            x, y = x[:, ::-1], y[:, ::-1]
        if radius is not None:
            x = gaussian_blur(x, radius)
        return self._normalize(x), np.ascontiguousarray(y)

    def get(self, index: int, rng: np.random.Generator):
        """→ (image (H,W,3) float32 or uint8, label (H,W) int32 or int8, name)."""
        img_path, lab_path = self._pair_paths(self.items[index])
        if self.training:
            fused = self._fused_train_sample(img_path, lab_path, rng)
        else:
            fused = self._fused_val_sample(img_path, lab_path)
        if fused is not None:
            x, y = fused
        else:
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
