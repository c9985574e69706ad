"""The port's fused sample routes against its general path and against the
JAX package's datasets.

Roots (``experiments/host_data.write_route_roots``): GTA5 with palette
label PNGs, Cityscapes train and val with gray label PNGs, SYNTHIA with
16-bit RGB label PNGs, and a raw-prepared (``.npy``) GTA5 root, all at base
size, so every sample takes a fused route (train: mirror and blur draws;
val: the identity). Each is held bitwise against the general path with the
extension off (PIL decode, resize and blur), for both ``device_normalize``
settings and both normalizations, and the sample stream against the JAX
dataset's ``get`` for the same seeds. On GTA5's palette labels the JAX side
runs its PIL path: its libpng extension reads a palette's red value there
(a reference defect). Interlaced and 16-bit gray files take the general
path. The raw route needs no extension, so its tests run everywhere.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
from PIL import Image

from maxsquareloss_torch.data import hostops
from maxsquareloss_torch.data.cityscapes import CityscapesDataset
from maxsquareloss_torch.data.palette import IMG_MEAN
from maxsquareloss_torch.experiments import host_data
from maxsquareloss_tpu.data import cityscapes as jcity
from maxsquareloss_tpu.data import gta5 as jgta5
from maxsquareloss_tpu.data import hostops as jax_hostops
from maxsquareloss_tpu.data import synthia as jsynthia
from maxsquareloss_tpu.data import transforms as jtransforms

HW = (24, 40)
BASE = (HW[1], HW[0])
needs_extension = pytest.mark.skipif(not hostops.available(), reason="no g++ or no zlib.h here")
ROOTS = ["gta5", "gta5_raw", "cityscapes_train", "cityscapes_val", "synthia"]


def _marks(root):
    return () if root == "gta5_raw" else (needs_extension,)


ROOT_PARAMS = [pytest.param(r, marks=_marks(r)) for r in ROOTS]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return host_data.write_route_roots(str(tmp_path_factory.mktemp("routes")),
                                       np.random.default_rng(0), HW)


@pytest.mark.parametrize("device_normalize", [False, True], ids=["host_norm", "device_norm"])
@pytest.mark.parametrize("root", ROOT_PARAMS)
def test_fused_routes_equal_the_general_path(roots, root, device_normalize):
    for numpy_transform in (True, False):
        r = host_data.route_case(roots[root], HW, device_normalize,
                                 numpy_transform=numpy_transform)
        assert r["equal"], (root, numpy_transform)
        assert r["fused"] == r["samples"], "a sample took the general path"


def test_train_draws_cover_mirror_and_blur(roots):
    """The roots' train samples meet every (mirror, blur) pair of draws."""
    cfg = jtransforms.TransformConfig()
    seen = set()
    for e in range(2):
        for i in range(4):
            rng = np.random.default_rng((host_data.ROUTE_SEED, e, i))
            flip = rng.random() < 0.5
            seen.add((bool(flip), bool(cfg.gaussian_blur and rng.random() < cfg.blur_prob)))
    assert seen == {(a, b) for a in (False, True) for b in (False, True)}


JAX_CLS = {"gta5": jgta5.GTA5Dataset, "cityscapes": jcity.CityscapesDataset,
           "synthia": jsynthia.SynthiaDataset}


@pytest.mark.parametrize("device_normalize", [False, True], ids=["host_norm", "device_norm"])
@pytest.mark.parametrize("root", ROOT_PARAMS)
def test_stream_equals_the_jax_dataset(roots, root, device_normalize, monkeypatch):
    from maxsquareloss_torch.data.transforms import TransformConfig
    from maxsquareloss_torch.tools.common import DATASET_CLS

    if root == "gta5":  # palette labels: the JAX extension reads red, its PIL path indices
        monkeypatch.setattr(jax_hostops, "_ext", False)
    name, path, list_path, split = roots[root]
    kw = dict(base_size=BASE, crop_size=BASE, device_normalize=device_normalize)
    port = DATASET_CLS[name](path, list_path, split=split, transform_cfg=TransformConfig(**kw),
                             class_16=name == "synthia")
    ref = JAX_CLS[name](path, list_path, split=split,
                        transform_cfg=jtransforms.TransformConfig(**kw),
                        class_16=name == "synthia")
    for e in range(2):
        for i in range(len(port)):
            xa, ya, na = port.get(i, np.random.default_rng((3, e, i)))
            xb, yb, nb = ref.get(i, np.random.default_rng((3, e, i)))
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype and na == nb
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb), (root, e, i)


def _write_val_pair(root, rel, img_png: bytes, lab_png: bytes):
    lrel = rel.replace("leftImg8bit", "gtFine", 1).replace(
        "_leftImg8bit.png", "_gtFine_labelIds.png")
    for p, data in ((rel, img_png), (lrel, lab_png)):
        os.makedirs(os.path.dirname(os.path.join(root, p)), exist_ok=True)
        with open(os.path.join(root, p), "wb") as f:
            f.write(data)
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write(rel)


@needs_extension
@pytest.mark.parametrize("kind", ["interlaced", "gray16_image", "gray4_label"])
def test_files_the_extension_does_not_read_as_pil_take_the_general_path(tmp_path, kind):
    """An interlaced pair, a 16-bit gray image (PIL clips it to 255) and a
    4-bit gray label (PIL scales it by 17): no fused route, and the sample is
    PIL's."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (*HW, 3))
    ids = rng.choice([7, 8, 11, 0, 255], HW)[..., None]
    img_png = host_data.encode_png(img, 2, 8)
    lab_png = host_data.encode_png(ids, 0, 8)
    if kind == "interlaced":
        img_png = host_data.encode_png(img, 2, 8, filters=(1, 4), interlace=True)
        lab_png = host_data.encode_png(ids, 0, 8, interlace=True)
    elif kind == "gray16_image":
        img_png = host_data.encode_png(rng.integers(0, 65536, (*HW, 1)), 0, 16)
    else:
        lab_png = host_data.encode_png(rng.integers(0, 16, (*HW, 1)), 0, 4)
    root = str(tmp_path)
    rel = "leftImg8bit/val/a/a_000000_leftImg8bit.png"
    _write_val_pair(root, rel, img_png, lab_png)
    from maxsquareloss_torch.data.transforms import TransformConfig

    ds = CityscapesDataset(root, os.path.join(root, "val.txt"), split="val",
                           transform_cfg=TransformConfig(base_size=BASE, crop_size=BASE))
    img_path, lab_path = ds._pair_paths(rel)
    assert ds._fused_val_sample(img_path, lab_path) is None
    x, y, _ = ds.get(0, np.random.default_rng(0))
    with host_data.general_path_only():
        xp, yp, _ = ds.get(0, np.random.default_rng(0))
    assert np.array_equal(x, xp) and np.array_equal(y, yp)
    want = np.asarray(Image.open(os.path.join(root, rel)).convert("RGB"))
    assert np.array_equal(x, want[..., ::-1].astype(np.float32) - IMG_MEAN)


def test_raw_route_needs_no_extension(roots, monkeypatch):
    """Without the extension the raw-prepared root still takes its route,
    and gives the same bits."""
    from maxsquareloss_torch.data.gta5 import GTA5Dataset
    from maxsquareloss_torch.data.transforms import TransformConfig

    _, path, list_path, split = roots["gta5_raw"]
    ds = GTA5Dataset(path, list_path, split=split,
                     transform_cfg=TransformConfig(base_size=BASE, crop_size=BASE))
    want = ds.get(1, np.random.default_rng(9))
    monkeypatch.setattr(hostops, "available", lambda: False)
    assert ds._fused_train_sample(*ds._pair_paths(ds.items[1]), np.random.default_rng(9))
    got = ds.get(1, np.random.default_rng(9))
    assert all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
