"""SYNTHIA-RAND-CITYSCAPES dataset (the port's own copy of
``maxsquareloss_tpu/data/synthia.py``).

Labels are 16-bit multi-channel PNGs with the class id in the file's first
(R) channel; SYNTHIA ids remap to the 16 trainIds it shares with Cityscapes
(no terrain, truck or train). PIL cannot read 16-bit colour PNGs: the
label decode takes the host extension (``data/hostops.py``: the stored
samples, channel 0 = R) where it builds, else OpenCV, or imageio where
OpenCV is missing, as the JAX package does; raw ``.npy`` sidecars need none
of them.
"""

from __future__ import annotations

import os

import numpy as np

from maxsquareloss_torch.data import hostops
from maxsquareloss_torch.data.cityscapes import (
    PngHeader,
    SegDataset,
    _first_channel,
    _label_image,
    _native_bytes,
)

# SYNTHIA id → Cityscapes trainId (16 shared classes)
SYNTHIA_ID_TO_TRAINID = {
    3: 0,    # road
    4: 1,    # sidewalk
    2: 2,    # building
    21: 3,   # wall
    5: 4,    # fence
    7: 5,    # pole
    15: 6,   # traffic light
    9: 7,    # traffic sign
    6: 8,    # vegetation
    1: 10,   # sky
    10: 11,  # person
    17: 12,  # rider
    8: 13,   # car
    19: 15,  # bus
    12: 17,  # motorcycle
    11: 18,  # bicycle
}


def read_label_ids(path: str) -> np.ndarray:
    """The class ids of a SYNTHIA label PNG: its first (R) channel."""
    try:
        import cv2
    except ImportError:
        import imageio

        raw = np.asarray(imageio.imread(path, format="PNG-FI"))
        return raw[:, :, 0] if raw.ndim == 3 else raw  # RGB(A) order: R is 0
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise OSError(f"cv2 failed to read {path}")
    return raw[:, :, 2] if raw.ndim == 3 else raw  # BGR(A) order: R is 2


class SynthiaDataset(SegDataset):
    id_to_trainid = SYNTHIA_ID_TO_TRAINID

    def _pair_paths(self, item: str) -> tuple[str, str]:
        if " " in item:
            return super()._pair_paths(item)
        name = os.path.basename(item)
        return (
            os.path.join(self.root, "RGB", name),
            os.path.join(self.root, "GT", "LABELS", name),
        )

    def _native_label(self, hdr: PngHeader) -> bool:
        """Files whose stored samples OpenCV reads unchanged: 8- and 16-bit,
        no palette (OpenCV expands one to colours), not interlaced."""
        return not hdr.interlaced and hdr.depth >= 8 and hdr.color != 3

    def _decode_mask(self, path: str):
        """→ PIL 'I' image of raw SYNTHIA class ids (exact through NEAREST)."""
        data = _native_bytes(path, self._native_label)
        if data is None:
            ids = read_label_ids(path)
        else:
            ids = _first_channel(hostops.decode_png(data, False))
        return _label_image(ids.astype(np.int32))
