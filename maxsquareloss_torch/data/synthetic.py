"""Synthetic segmentation data (the port's own copy of
``maxsquareloss_tpu/data/synthetic.py``, numpy only).

- ``SyntheticSegDataset``: deterministic in-memory pairs with the dataset
  interface, no files on disk; ``uint8_batches`` turns it into the uint8
  image / int32 label batches the serving path takes.
- ``DomainShiftRenderer`` / ``write_domain_shift_pair``: the synthetic
  domain-shift pair (class colours on an RGB lattice, a global colour shift
  on the target) written in the GTA5 + Cityscapes layouts, which the CLIs
  train on; ``write_crosscity`` writes one NTHU city. PIL is imported only
  to write the PNGs.
"""

from __future__ import annotations

import os
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


# Cityscapes raw label ids that map to trainIds 0..18
MAPPED_RAW_IDS = (
    7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33,
)


def lattice_colors(spacing: float = 80.0) -> np.ndarray:
    """(19, 3) float32 class colours on a 3x3x3 RGB lattice, shuffled so
    that neighbouring trainIds are not neighbouring colours."""
    lo = 127.5 - spacing
    levels = np.asarray([lo, 127.5, lo + 2 * spacing], np.float32)
    grid = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), axis=-1).reshape(27, 3)
    order = np.random.default_rng(12345).permutation(27)[:19]
    return grid[order]


class DomainShiftRenderer:
    """Shared label geometry; per-domain photometric rendering."""

    def __init__(
        self,
        hw: tuple[int, int] = (64, 128),
        spacing: float = 80.0,
        sigma: float = 18.0,
        shift: tuple[float, float, float] = (24.0, -24.0, 24.0),
        patch: int = 16,
        seed: int = 0,
    ):
        self.hw = hw
        self.colors = lattice_colors(spacing)
        self.sigma = sigma
        self.shift = np.asarray(shift, np.float32)
        self.patch = patch
        self.seed = seed

    def label_field(self, g: np.random.Generator) -> np.ndarray:
        """Blocky 19-class trainId field with a dominant background class."""
        h, w = self.hw
        lab = np.full((h, w), int(g.integers(0, 19)), np.int32)  # background
        for _ in range(6):
            c = int(g.integers(0, 19))
            y0 = int(g.integers(0, max(1, h - 12)))
            x0 = int(g.integers(0, max(1, w - 12)))
            y1 = y0 + int(g.integers(12, h // 2 + 1))
            x1 = x0 + int(g.integers(12, w // 2 + 1))
            lab[y0:y1, x0:x1] = c
        return lab

    def render(self, lab: np.ndarray, g: np.random.Generator, target: bool) -> np.ndarray:
        """uint8 HWC image: class colour + low-frequency noise (+ shift)."""
        h, w = self.hw
        p = self.patch
        gh, gw = -(-h // p), -(-w // p)
        # per-tile noise, constant over patch x patch tiles
        noise = g.normal(0.0, self.sigma, size=(gh, gw, 3)).astype(np.float32)
        noise = np.repeat(np.repeat(noise, p, axis=0), p, axis=1)[:h, :w]
        img = self.colors[lab] + noise
        if target:
            img = img + self.shift
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)

    def sample(self, domain: str, index: int) -> tuple[np.ndarray, np.ndarray]:
        """(uint8 image, int32 trainId label), deterministic by (seed, domain, index)."""
        import zlib  # stable across processes (str hash() is salted)

        g = np.random.default_rng((self.seed, zlib.crc32(domain.encode()), index))
        lab = self.label_field(g)
        return self.render(lab, g, target=domain.startswith("target")), lab


def write_domain_shift_pair(
    base: str,
    n_source: int = 32,
    n_target_train: int = 32,
    n_target_val: int = 16,
    **renderer_kw,
) -> DomainShiftRenderer:
    """Write the pair on disk: ``<base>/GTA5`` (labeled source, train.txt)
    and ``<base>/Cityscapes`` (target train split, whose labels the UDA
    trainer never reads, and the labeled val split)."""
    from PIL import Image

    r = DomainShiftRenderer(**renderer_kw)
    trainid_to_raw = np.asarray(MAPPED_RAW_IDS, np.uint8)

    g5 = os.path.join(base, "GTA5")
    os.makedirs(os.path.join(g5, "images"), exist_ok=True)
    os.makedirs(os.path.join(g5, "labels"), exist_ok=True)
    items = []
    for i in range(n_source):
        img, lab = r.sample("source", i)
        name = f"{i:05d}.png"
        Image.fromarray(img).save(os.path.join(g5, "images", name))
        Image.fromarray(trainid_to_raw[lab]).save(os.path.join(g5, "labels", name))
        items.append(name)
    with open(os.path.join(g5, "train.txt"), "w") as f:
        f.write("\n".join(items))

    cs = os.path.join(base, "Cityscapes")
    for split, n in (("train", n_target_train), ("val", n_target_val)):
        rels = []
        for i in range(n):
            rel = f"leftImg8bit/{split}/synth/synth_{i:06d}_leftImg8bit.png"
            lrel = rel.replace("leftImg8bit", "gtFine", 1).replace(
                "_leftImg8bit.png", "_gtFine_labelIds.png"
            )
            os.makedirs(os.path.dirname(os.path.join(cs, rel)), exist_ok=True)
            os.makedirs(os.path.dirname(os.path.join(cs, lrel)), exist_ok=True)
            img, lab = r.sample(f"target_{split}", i)
            Image.fromarray(img).save(os.path.join(cs, rel))
            Image.fromarray(trainid_to_raw[lab]).save(os.path.join(cs, lrel))
            rels.append(rel)
        with open(os.path.join(cs, f"{split}.txt"), "w") as f:
            f.write("\n".join(rels))
    return r


def write_crosscity(
    base: str,
    city: str = "Rio",
    n_train: int = 8,
    n_val: int = 8,
    hw: tuple[int, int] = (64, 128),
    seed: int = 1,
) -> None:
    """Write one NTHU city, ``<base>/NTHU/<city>/{Images,Labels}/{Train,
    Test}``, with ``<base>/NTHU/{train,val}.txt``: per-pixel random raw
    Cityscapes ids and each pixel painted its class colour."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    colors = np.zeros((256, 3), np.uint8)
    colors[list(MAPPED_RAW_IDS)] = np.rint(lattice_colors()).astype(np.uint8)
    root = os.path.join(base, "NTHU")
    for sub, n, list_name in (("Train", n_train, "train"), ("Test", n_val, "val")):
        os.makedirs(os.path.join(root, city, "Images", sub), exist_ok=True)
        os.makedirs(os.path.join(root, city, "Labels", sub), exist_ok=True)
        names = []
        for i in range(n):
            name = f"{sub.lower()}_{i:04d}.png"
            lab = rng.choice(MAPPED_RAW_IDS, size=hw).astype(np.uint8)
            Image.fromarray(colors[lab]).save(os.path.join(root, city, "Images", sub, name))
            Image.fromarray(lab).save(os.path.join(root, city, "Labels", sub, name))
            names.append(name)
        with open(os.path.join(root, f"{list_name}.txt"), "w") as f:
            f.write("\n".join(names))
