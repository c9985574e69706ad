"""NTHU Cross-City dataset (the port's own copy of
``maxsquareloss_tpu/data/crosscity.py``).

Rio / Rome / Tokyo / Taipei on the 13-class protocol: an unlabeled target
train split and a small labeled val split. Labels use Cityscapes ids;
evaluation and (optionally) training use the 13-class subset, compacted to
0..12 when ``relabel_13``.
"""

from __future__ import annotations

import os

from maxsquareloss_torch.data.cityscapes import CITYSCAPES_ID_TO_TRAINID, SegDataset

CITIES = ("Rio", "Rome", "Tokyo", "Taipei")


class CrossCityDataset(SegDataset):
    id_to_trainid = CITYSCAPES_ID_TO_TRAINID

    def __init__(self, root: str, list_path: str, city_name: str = "Rio", **kw):
        if city_name not in CITIES:
            raise ValueError(f"unknown city {city_name!r}")
        self.city_name = city_name
        kw.setdefault("class_13", True)
        super().__init__(root, list_path, **kw)

    def _pair_paths(self, item: str) -> tuple[str, str]:
        if " " in item:
            img_rel, lab_rel = item.split()[:2]
            return (
                os.path.join(self.root, self.city_name, img_rel),
                os.path.join(self.root, self.city_name, lab_rel),
            )
        sub = "Train" if self.split == "train" else "Test"
        name = os.path.basename(item)
        return (
            os.path.join(self.root, self.city_name, "Images", sub, name),
            os.path.join(self.root, self.city_name, "Labels", sub, name),
        )
