"""The port's ``tools.prepare_dataset`` against the JAX package's.

``prepare_split`` of the port and of ``tools/prepare_dataset.py`` must
write the same files with the same decoded pixels, in both formats (lossless
PNG and raw ``.npy`` sidecars), for GTA5, Cityscapes and a cross-city split
whose train images have no labels. A re-run reuses fresh outputs and redoes
stale ones. With ``random_mirror`` off, the port's loader stream over a
prepared root is bitwise its stream over the original root.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, ".")

from maxsquareloss_torch.data import loader as tloader
from maxsquareloss_torch.data.synthetic import write_crosscity, write_domain_shift_pair
from maxsquareloss_torch.data.transforms import TransformConfig
from maxsquareloss_torch.tools import prepare_dataset
from maxsquareloss_torch.tools.common import DATASET_CLS
from maxsquareloss_torch.tools.prepare_dataset import prepare_split

HW = (40, 72)  # on disk (H, W); prepared at BASE (W, H)
BASE = (48, 24)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """GTA5 + Cityscapes (train, val) + NTHU Rio; one Rio train label removed."""
    base = str(tmp_path_factory.mktemp("orig"))
    write_domain_shift_pair(base, n_source=3, n_target_train=3, n_target_val=3, hw=HW)
    write_crosscity(base, "Rio", n_train=3, n_val=2, hw=HW)
    os.remove(os.path.join(base, "NTHU", "Rio", "Labels", "Train", "train_0001.png"))
    return base


SPLITS = {  # dataset → (folder, split, extra kwargs)
    "gta5": ("GTA5", "train", {}),
    "cityscapes": ("Cityscapes", "val", {}),
    "crosscity": ("NTHU", "train", {"city_name": "Rio"}),
}


def _files(root: str) -> dict[str, np.ndarray]:
    """Every written file under ``root``: decoded pixels, or list text."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npy"):
                out[rel] = np.load(path)
            elif name.endswith(".png"):
                out[rel] = np.asarray(Image.open(path))
            else:
                out[rel] = open(path).read()
    return out


@pytest.mark.parametrize("fmt", ["png", "raw"])
@pytest.mark.parametrize("dataset", list(SPLITS))
def test_prepared_pixels_match_jax(data, tmp_path, dataset, fmt):
    from tools.prepare_dataset import prepare_split as jprepare_split

    folder, split, kw = SPLITS[dataset]
    root = os.path.join(data, folder)
    list_path = os.path.join(root, f"{split}.txt")
    outs = {side: str(tmp_path / side / folder) for side in ("port", "jax")}
    n = prepare_split(dataset, root, list_path, outs["port"], BASE, split, num_workers=2,
                      fmt=fmt, **kw)
    m = jprepare_split(dataset, root, list_path, outs["jax"], BASE, split, num_workers=2,
                       fmt=fmt, **kw)
    assert n == m == 3
    port, ref = _files(outs["port"]), _files(outs["jax"])
    assert sorted(port) == sorted(ref)
    assert any(k.endswith(".npy" if fmt == "raw" else ".png") for k in port)
    for rel, want in ref.items():
        got = port[rel]
        if isinstance(want, str):
            assert got == want, rel
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), rel
            assert got.shape[:2] == (BASE[1], BASE[0]), rel
    if dataset == "crosscity":  # the unlabeled train image wrote no label
        assert not any("Labels/Train/train_0001" in rel for rel in port)


def _mtimes(root: str) -> dict[str, float]:
    return {os.path.join(d, n): os.path.getmtime(os.path.join(d, n))
            for d, _, names in os.walk(root) for n in names if not n.endswith(".txt")}


@pytest.mark.parametrize("fmt", ["png", "raw"])
def test_fresh_outputs_are_reused_and_stale_ones_redone(data, tmp_path, fmt):
    root = str(tmp_path / "orig")  # a copy: the test touches an input's mtime
    shutil.copytree(os.path.join(data, "GTA5"), root)
    out = str(tmp_path / "GTA5")
    prepare_split("gta5", root, os.path.join(root, "train.txt"), out, BASE, "train", fmt=fmt)
    first = _mtimes(out)
    time.sleep(0.05)
    prepare_split("gta5", root, os.path.join(root, "train.txt"), out, BASE, "train", fmt=fmt)
    assert _mtimes(out) == first  # fresh: nothing rewritten

    # an input newer than its output: that pair is redone, the others kept
    src = os.path.join(root, "images", "00001.png")
    later = max(first.values()) + 10
    os.utime(src, (later, later))
    prepare_split("gta5", root, os.path.join(root, "train.txt"), out, BASE, "train", fmt=fmt)
    again = _mtimes(out)
    redone = sorted(os.path.relpath(p, out) for p in again if again[p] != first[p])
    suffix = ".npy" if fmt == "raw" else ""
    assert redone == [f"images/00001.png{suffix}", f"labels/00001.png{suffix}"]

    # another base size: every output is stale
    prepare_split("gta5", root, os.path.join(root, "train.txt"), out, (24, 12), "train", fmt=fmt)
    img = os.path.join(out, "images", "00000.png")
    if fmt == "raw":
        assert np.load(img + ".npy").shape == (12, 24, 3)
        # a png prepare over a raw root removes the sidecars the loader prefers
        prepare_split("gta5", root, os.path.join(root, "train.txt"), out, BASE, "train")
        assert not os.path.exists(img + ".npy") and Image.open(img).size == BASE
    else:
        assert Image.open(img).size == (24, 12)


@pytest.mark.parametrize("fmt", ["png", "raw"])
@pytest.mark.parametrize("dataset,split", [("gta5", "train"), ("cityscapes", "val")])
def test_stream_over_prepared_root_equals_original(data, tmp_path, dataset, split, fmt):
    folder = {"gta5": "GTA5", "cityscapes": "Cityscapes"}[dataset]
    root = os.path.join(data, folder)
    out = str(tmp_path / folder)
    prepare_split(dataset, root, os.path.join(root, f"{split}.txt"), out, BASE, split, fmt=fmt)
    cfg = TransformConfig(base_size=BASE, crop_size=(40, 20), random_crop=split == "train",
                          random_mirror=False, gaussian_blur=True)
    if split == "val":
        cfg = TransformConfig(base_size=BASE, crop_size=BASE)
    loaders = [tloader.SegDataLoader(
        DATASET_CLS[dataset](r, os.path.join(r, f"{split}.txt"), split=split, transform_cfg=cfg),
        batch_size=2, num_workers=2, seed=4, shuffle=split == "train",
        drop_last=split == "train", pad_last=split != "train") for r in (root, out)]
    n = 0
    for _ in range(2):
        for (xa, ya, na), (xb, yb, nb) in zip(*loaders, strict=True):
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb) and na == nb
            n += 1
    assert n > 0


def test_main_mirrors_the_layout(data, tmp_path, capsys):
    out = str(tmp_path / "prepared")
    prepare_dataset.main(["--dataset", "cityscapes", "--data_root_path", data,
                          "--output_root", out, "--base_size", "48,24", "--splits", "train,val",
                          "--format", "raw"])
    assert capsys.readouterr().out.count("prepared cityscapes/") == 2
    for split in ("train", "val"):
        with open(os.path.join(out, "Cityscapes", f"{split}.txt")) as f:
            rels = f.read().split()
        assert len(rels) == 3
        assert all(os.path.exists(os.path.join(out, "Cityscapes", r + ".npy")) for r in rels)
    with pytest.raises(SystemExit):
        prepare_dataset.main(["--dataset", "gta5", "--data_root_path", data, "--output_root",
                              out, "--splits", "train,val", "--list_path", "x.txt"])
