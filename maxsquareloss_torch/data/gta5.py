"""GTA5 dataset (the port's own copy of ``maxsquareloss_tpu/data/gta5.py``).

GTA5 renders use Cityscapes label ids, so the remap is the Cityscapes one;
images live in ``images/NNNNN.png`` with labels ``labels/NNNNN.png``.
"""

from __future__ import annotations

import os

from maxsquareloss_torch.data.cityscapes import CITYSCAPES_ID_TO_TRAINID, SegDataset


class GTA5Dataset(SegDataset):
    id_to_trainid = CITYSCAPES_ID_TO_TRAINID

    def _pair_paths(self, item: str) -> tuple[str, str]:
        if " " in item:
            return super()._pair_paths(item)
        name = os.path.basename(item)
        return (
            os.path.join(self.root, "images", name),
            os.path.join(self.root, "labels", name),
        )
