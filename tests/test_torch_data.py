"""The port's datasets and ``SegDataLoader`` against the JAX package's, over
the same tiny on-disk fixture (64x128 PNGs with raw label ids, in the GTA5,
Cityscapes and SYNTHIA layouts, written as ``tests/test_data.py`` writes
them): the streams must be bitwise equal (``np.array_equal``) over two
epochs. Train transforms (mirror, blur, random crop) and val; resize and
identity base sizes; ``device_normalize``; the base-size cache;
``set_skip``, ``pad_last`` and shards; the 16/13-class filters and the
SYNTHIA 16-bit labels. The JAX side runs with its native host ops switched
off (its PIL path) and as built (its native fast paths where the extension
is built), which reproduce the PIL path exactly.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
from PIL import Image

from maxsquareloss_torch.data import cityscapes as tcity
from maxsquareloss_torch.data import gta5 as tgta5
from maxsquareloss_torch.data import loader as tloader
from maxsquareloss_torch.data import synthia as tsynthia
from maxsquareloss_torch.data import transforms as ttransforms
from maxsquareloss_tpu.data import cityscapes as jcity
from maxsquareloss_tpu.data import gta5 as jgta5
from maxsquareloss_tpu.data import hostops
from maxsquareloss_tpu.data import loader as jloader
from maxsquareloss_tpu.data import synthia as jsynthia
from maxsquareloss_tpu.data import transforms as jtransforms

H, W, N_ITEMS = 64, 128, 6
RAW_IDS = list(jcity.CITYSCAPES_ID_TO_TRAINID) + [0, 1, 4, 255]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """GTA5 (train) and Cityscapes (train, val) roots; raw Cityscapes ids."""
    base = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)

    def write(img_path, lab_path):
        os.makedirs(os.path.dirname(img_path), exist_ok=True)
        os.makedirs(os.path.dirname(lab_path), exist_ok=True)
        Image.fromarray(rng.integers(0, 255, size=(H, W, 3)).astype(np.uint8)).save(img_path)
        Image.fromarray(rng.choice(RAW_IDS, size=(H, W)).astype(np.uint8)).save(lab_path)

    g5 = base / "GTA5"
    names = [f"{i:05d}.png" for i in range(N_ITEMS)]
    for name in names:
        write(str(g5 / "images" / name), str(g5 / "labels" / name))
    (g5 / "train.txt").write_text("\n".join(names))
    cs = base / "Cityscapes"
    for split in ("train", "val"):
        rels = []
        for i in range(N_ITEMS):
            rel = f"leftImg8bit/{split}/cityA/cityA_{i:06d}_leftImg8bit.png"
            lrel = rel.replace("leftImg8bit", "gtFine", 1).replace(
                "_leftImg8bit.png", "_gtFine_labelIds.png")
            write(str(cs / rel), str(cs / lrel))
            rels.append(rel)
        (cs / f"{split}.txt").write_text("\n".join(rels))
    return {"gta5": (str(g5), str(g5 / "train.txt")),
            "cityscapes_train": (str(cs), str(cs / "train.txt")),
            "cityscapes_val": (str(cs), str(cs / "val.txt"))}


@pytest.fixture(params=["jax_pil", "jax_native_if_built"])
def jax_hostops(request, monkeypatch):
    if request.param == "jax_pil":
        monkeypatch.setattr(hostops, "_load", lambda: False)
    return request.param


def _pair(kind, root, list_path, split, tkw, **kw):
    """(port dataset, JAX dataset) of one kind over the same files."""
    mods = {"gta5": (tgta5.GTA5Dataset, jgta5.GTA5Dataset),
            "cityscapes": (tcity.CityscapesDataset, jcity.CityscapesDataset),
            "synthia": (tsynthia.SynthiaDataset, jsynthia.SynthiaDataset)}[kind]
    port_kw, jax_kw = dict(kw), dict(kw)
    if "cache_dir" in kw:
        port_kw["cache_dir"] = kw["cache_dir"] + "_port"
        jax_kw["cache_dir"] = kw["cache_dir"] + "_jax"
    return (mods[0](root, list_path, split=split,
                    transform_cfg=ttransforms.TransformConfig(**tkw), **port_kw),
            mods[1](root, list_path, split=split,
                    transform_cfg=jtransforms.TransformConfig(**tkw), **jax_kw))


def _assert_streams_equal(port_loader, jax_loader, epochs=2):
    n = 0
    for _ in range(epochs):
        for (xa, ya, na), (xb, yb, nb) in zip(port_loader, jax_loader, strict=True):
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb) and na == nb
            n += 1
    assert n > 0
    return n


def _loaders(port_ds, jax_ds, **kw):
    kw = {"batch_size": 2, "num_workers": 2, "seed": 5, **kw}
    return tloader.SegDataLoader(port_ds, **kw), jloader.SegDataLoader(jax_ds, **kw)


TRAIN_CASES = {
    # base size = file size: the JAX package's fused native train path
    "identity_mirror_blur": dict(base_size=(W, H), crop_size=(W, H)),
    "resize_crop_blur": dict(base_size=(96, 48), crop_size=(64, 32), random_crop=True),
    "no_mirror_no_blur": dict(base_size=(W, H), crop_size=(W, H), random_mirror=False,
                              gaussian_blur=False),
    "torchvision_norm": dict(base_size=(W, H), crop_size=(W, H), numpy_transform=False),
    "device_normalize": dict(base_size=(96, 48), crop_size=(96, 48), device_normalize=True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_streams_bitwise_equal(roots, jax_hostops, case):
    port_ds, jax_ds = _pair("gta5", *roots["gta5"], "train", TRAIN_CASES[case])
    _assert_streams_equal(*_loaders(port_ds, jax_ds, shuffle=True))


@pytest.mark.parametrize("base_size", [(W, H), (96, 48)], ids=["identity", "resize"])
def test_val_streams_bitwise_equal(roots, jax_hostops, base_size):
    port_ds, jax_ds = _pair("cityscapes", *roots["cityscapes_val"], "val",
                            dict(base_size=base_size, crop_size=base_size))
    _assert_streams_equal(*_loaders(port_ds, jax_ds, shuffle=False, drop_last=False,
                                    batch_size=4, pad_last=True))


def test_full_res_labels_and_cache(roots, tmp_path):
    """Val labels kept at file size; train samples through the base-size cache."""
    port_ds, jax_ds = _pair("cityscapes", *roots["cityscapes_val"], "val",
                            dict(base_size=(96, 48), crop_size=(96, 48)), full_res_labels=True)
    _assert_streams_equal(*_loaders(port_ds, jax_ds, shuffle=False, drop_last=False))
    port_ds, jax_ds = _pair("cityscapes", *roots["cityscapes_train"], "train",
                            dict(base_size=(96, 48), crop_size=(64, 32), random_crop=True),
                            cache_dir=str(tmp_path / "cache"))
    _assert_streams_equal(*_loaders(port_ds, jax_ds), epochs=2)  # fills, then reads


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("pad_last", [False, True])
def test_shards_and_pad_last(roots, shards, pad_last):
    tkw = dict(base_size=(96, 48), crop_size=(96, 48))
    port_ds, jax_ds = _pair("cityscapes", *roots["cityscapes_val"], "val", tkw)
    for index in range(shards):
        # 6 items over 4 shards: one each, or two with padding slots
        pl, jl = _loaders(port_ds, jax_ds, shuffle=True, drop_last=not pad_last,
                          pad_last=pad_last, shard_index=index, shard_count=shards,
                          batch_size=2 if pad_last else 1)
        assert pl.num_iterations == jl.num_iterations == len(pl)
        _assert_streams_equal(pl, jl)


def test_set_epoch_and_set_skip(roots):
    """Resume semantics: a pinned epoch, and the tail of it after a skip."""
    port_ds, jax_ds = _pair("gta5", *roots["gta5"], "train", TRAIN_CASES["identity_mirror_blur"])
    pl, jl = _loaders(port_ds, jax_ds)
    for loader in (pl, jl):
        loader.set_epoch(3)
        loader.set_skip(1)
    assert _assert_streams_equal(pl, jl, epochs=1) == N_ITEMS // 2 - 1
    # the skip is for one epoch only; the epoch advanced to 4
    assert pl.epoch == jl.epoch == 4
    full = list(pl)
    pl.set_epoch(4)
    pl.set_skip(2)
    assert [n for *_, n in list(pl)] == [n for *_, n in full[2:]]


def test_abandoned_loader_advances_its_epoch(roots):
    port_ds, _ = _pair("gta5", *roots["gta5"], "train", TRAIN_CASES["no_mirror_no_blur"])
    pl = tloader.SegDataLoader(port_ds, batch_size=2, num_workers=1, seed=3)
    first = next(iter(pl))[2]
    second = next(iter(pl))[2]
    assert pl.epoch == 2 and first != second


@pytest.mark.parametrize("filt", ["class_16", "class_13", "class_13_relabel"])
def test_class_filters(roots, filt):
    kw = {"class_16": {"class_16": True}, "class_13": {"class_13": True},
          "class_13_relabel": {"class_13": True, "relabel_13": True}}[filt]
    port_ds, jax_ds = _pair("cityscapes", *roots["cityscapes_val"], "val",
                            dict(base_size=(W, H), crop_size=(W, H)), **kw)
    _assert_streams_equal(*_loaders(port_ds, jax_ds, shuffle=False, drop_last=False))
    _, y, _ = port_ds.get(0, np.random.default_rng(0))
    if filt == "class_16":
        assert not np.isin(y, [9, 14, 16]).any()
    if filt == "class_13_relabel":
        assert y.max() < 13


def test_synthia_16bit_labels_and_remap(tmp_path, jax_hostops):
    """SYNTHIA: 16-bit 3-channel label PNGs, class id in the R channel, the
    16-class id remap, on the 16-class protocol."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    root = tmp_path / "SYNTHIA"
    (root / "RGB").mkdir(parents=True)
    (root / "GT" / "LABELS").mkdir(parents=True)
    names = [f"{i:07d}.png" for i in range(4)]
    for name in names:
        Image.fromarray(rng.integers(0, 255, size=(H, W, 3)).astype(np.uint8)).save(
            root / "RGB" / name)
        bgr = rng.integers(0, 65535, size=(H, W, 3)).astype(np.uint16)
        bgr[:, :, 2] = rng.integers(0, 23, size=(H, W))  # R: the class id
        assert cv2.imwrite(str(root / "GT" / "LABELS" / name), bgr)
    (root / "train.txt").write_text("\n".join(names))
    port_ds, jax_ds = _pair("synthia", str(root), str(root / "train.txt"), "train",
                            dict(base_size=(96, 48), crop_size=(96, 48)), class_16=True)
    _assert_streams_equal(*_loaders(port_ds, jax_ds))
    _, y, _ = port_ds.get(0, np.random.default_rng(0))
    assert set(np.unique(y)) <= set(tsynthia.SYNTHIA_ID_TO_TRAINID.values()) | {-1}
    assert tsynthia.SYNTHIA_ID_TO_TRAINID == jsynthia.SYNTHIA_ID_TO_TRAINID


def test_protocol_constants_match():
    assert tcity.CITYSCAPES_ID_TO_TRAINID == jcity.CITYSCAPES_ID_TO_TRAINID
    assert tcity.TRAINID_SET_16 == jcity.TRAINID_SET_16
    assert tcity.TRAINID_SET_13 == jcity.TRAINID_SET_13
    for keep, relabel in ((jcity.TRAINID_SET_16, False), (jcity.TRAINID_SET_13, True)):
        assert np.array_equal(tcity._subset_filter_lut(keep, relabel),
                              jcity._subset_filter_lut(keep, relabel))


def test_pad_sample_is_all_ignore():
    from maxsquareloss_torch.data.synthetic import SyntheticSegDataset

    ds = SyntheticSegDataset(length=5, hw=(8, 8))
    batches = list(tloader.SegDataLoader(ds, batch_size=4, shuffle=False, num_workers=1,
                                         drop_last=False, pad_last=True))
    xs, ys, names = batches[-1]
    assert xs.shape == (4, 8, 8, 3)
    assert names[1:] == [tloader._PAD_SAMPLE_NAME] * 3 and (ys[1:] == -1).all()


def test_device_prefetch_keeps_order_and_stops_early():
    """Batches come back as CPU tensors in order; abandoning the generator
    stops its thread."""
    import threading

    import torch

    from maxsquareloss_torch.data.synthetic import SyntheticSegDataset

    ds = SyntheticSegDataset(length=10, hw=(8, 8))
    dl = tloader.SegDataLoader(ds, batch_size=2, shuffle=False, num_workers=1)
    want = list(dl)
    got = list(tloader.device_prefetch(iter(dl), "cpu"))
    assert len(got) == len(want) == 5
    for (xa, ya, na), (xb, yb, nb) in zip(got, want):
        assert isinstance(xa, torch.Tensor) and np.array_equal(xa.numpy(), xb) and na == nb
        assert np.array_equal(ya.numpy(), yb)
    threads = threading.active_count()
    gen = tloader.device_prefetch(iter(dl), "cpu")
    next(gen)
    gen.close()
    assert threading.active_count() <= threads
