"""Synthetic in-memory segmentation data (port of
``maxsquareloss_tpu/data/synthetic.py`` ``SyntheticSegDataset``, numpy only).

``uint8_batches`` turns the dataset into the uint8 image / int32 label
batches the serving path takes, with no files on disk.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticSegDataset:
    """Deterministic random segmentation pairs, normalized like the pipeline."""

    def __init__(
        self,
        length: int = 64,
        hw: tuple[int, int] = (64, 64),
        num_classes: int = 19,
        ignore_frac: float = 0.05,
        seed: int = 0,
    ):
        self.length = length
        self.hw = hw
        self.num_classes = num_classes
        self.ignore_frac = ignore_frac
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def get(self, index: int, rng: np.random.Generator | None = None):
        del rng  # samples are fully deterministic by index
        g = np.random.default_rng((self.seed, index))
        h, w = self.hw
        x = g.normal(0.0, 60.0, size=(h, w, 3)).astype(np.float32)
        y = g.integers(0, self.num_classes, size=(h, w)).astype(np.int32)
        ignore = g.random((h, w)) < self.ignore_frac
        y[ignore] = -1
        return x, y, f"synthetic_{index:05d}"


def uint8_batches(
    ds: SyntheticSegDataset,
    batch_size: int,
    label_hw: tuple[int, int] | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, list[str]]]:
    """(uint8 NHWC images, int32 NHW labels, names) batches over ``ds``.

    Images are the samples shifted into [0, 255] and rounded. ``label_hw``
    replaces each label by a nearest-neighbour resample at that size (the
    full-resolution-label protocol), so labels and images may differ.
    """
    for start in range(0, len(ds), batch_size):
        xs, ys, names = [], [], []
        for i in range(start, min(start + batch_size, len(ds))):
            x, y, name = ds.get(i)
            xs.append(np.clip(np.rint(x + 128.0), 0, 255).astype(np.uint8))
            if label_hw is not None:
                rows = np.arange(label_hw[0]) * y.shape[0] // label_hw[0]
                cols = np.arange(label_hw[1]) * y.shape[1] // label_hw[1]
                y = y[rows][:, cols]
            ys.append(y)
            names.append(name)
        yield np.stack(xs), np.stack(ys), names
