"""The port's NTHU cross-city dataset and ``tools.solve_crosscity``.

The dataset's sample stream must be bitwise equal (``np.array_equal``) to
the JAX package's over two epochs: train and val, both list-line forms
(bare names under ``Images|Labels/{Train,Test}`` and explicit pairs),
``relabel_13`` on and off, two cities. The CLI runs 2 iterations of
Cityscapes → Rio on the CPU at a small depth, checkpoints and validates on
the 13-class protocol.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from maxsquareloss_torch.data import crosscity as tcross
from maxsquareloss_torch.data import loader as tloader
from maxsquareloss_torch.data import transforms as ttransforms
from maxsquareloss_torch.data.synthetic import write_crosscity, write_domain_shift_pair
from maxsquareloss_torch.tools import solve_crosscity
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_tpu.data import crosscity as jcross
from maxsquareloss_tpu.data import loader as jloader
from maxsquareloss_tpu.data import transforms as jtransforms

CITIES = ("Rio", "Tokyo")
HW = (40, 80)
TRANSFORMS = {
    "train": dict(base_size=(64, 32), crop_size=(48, 24), random_crop=True),
    "val": dict(base_size=(64, 32), crop_size=(64, 32)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nthu(tmp_path_factory):
    """Two cities under one NTHU root, with bare-name and explicit-pair lists."""
    base = str(tmp_path_factory.mktemp("nthu"))
    for seed, city in enumerate(CITIES):
        write_crosscity(base, city, n_train=5, n_val=4, hw=HW, seed=seed)
    root = os.path.join(base, "NTHU")
    lists = {}
    for split, sub in (("train", "Train"), ("val", "Test")):
        with open(os.path.join(root, f"{split}.txt")) as f:
            names = f.read().split()
        lists[(split, "names")] = os.path.join(root, f"{split}.txt")
        pairs = os.path.join(root, f"{split}_pairs.txt")
        with open(pairs, "w") as f:
            f.write("\n".join(f"Images/{sub}/{n} Labels/{sub}/{n}" for n in names))
        lists[(split, "pairs")] = pairs
    return root, lists


@pytest.mark.parametrize("relabel", [True, False], ids=["relabel_13", "trainids"])
@pytest.mark.parametrize("form", ["names", "pairs"])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("city", CITIES)
def test_streams_bitwise_equal(nthu, city, split, form, relabel):
    root, lists = nthu
    kw = dict(split=split, city_name=city, relabel_13=relabel)
    port = tcross.CrossCityDataset(
        root, lists[(split, form)], transform_cfg=ttransforms.TransformConfig(**TRANSFORMS[split]),
        **kw)
    ref = jcross.CrossCityDataset(
        root, lists[(split, form)], transform_cfg=jtransforms.TransformConfig(**TRANSFORMS[split]),
        **kw)
    lkw = dict(batch_size=2, num_workers=2, seed=3, shuffle=split == "train",
               drop_last=split == "train", pad_last=split != "train")
    pl, jl = tloader.SegDataLoader(port, **lkw), jloader.SegDataLoader(ref, **lkw)
    n = 0
    for _ in range(2):
        for (xa, ya, na), (xb, yb, nb) in zip(pl, jl, strict=True):
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb) and na == nb
            n += 1
    assert n > 0
    y = port.get(0, np.random.default_rng(0))[1]
    assert y.max() < (13 if relabel else 19) and (y >= 0).any()


def test_cities_and_default_protocol():
    assert tcross.CITIES == jcross.CITIES
    with pytest.raises(ValueError, match="unknown city"):
        tcross.CrossCityDataset(".", os.devnull, city_name="Paris")


@pytest.fixture(scope="module")
def pair_and_city(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cc"))
    write_domain_shift_pair(base, n_source=1, n_target_train=4, n_target_val=1, hw=(32, 64))
    write_crosscity(base, "Rio", n_train=4, n_val=2, hw=(32, 64))
    return base


SIZE = ["--base_size", "64,32", "--crop_size", "64,32", "--target_base_size", "64,32",
        "--target_crop_size", "64,32"]
COMMON = ["--blocks", "2,2,2,2", "--batch_size", "2", "--num_workers", "2",
          "--iter_max", "100", "--tqdm", "false", "--show_num_images", "0"]


def test_solve_crosscity_two_iterations(pair_and_city, tmp_path):
    run_dir = str(tmp_path / "run")
    trainer = solve_crosscity.main(["--city_name", "Rio", "--data_root_path", pair_and_city,
                                    "--checkpoint_dir", run_dir, "--iter_stop", "2",
                                    "--device", "cpu", *SIZE, *COMMON])
    assert trainer.state.iteration == 2 and trainer.cfg.num_classes == 13
    assert trainer.cfg.class_13 and trainer.num_eval_classes == 13
    blob = ckpt_lib.load_checkpoint(os.path.join(run_dir, ckpt_lib.LATEST))
    assert blob["iteration"] == 2
    heads = [v for k, v in blob["state_dict"].items() if k.startswith("layer6.") and v.ndim == 4]
    assert heads and all(v.shape[0] == 13 for v in heads)
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    miou = [r["value"] for r in recs if r["tag"] == "val/MIoU" and r["step"] == 2]
    assert miou and math.isfinite(miou[0])


def test_solve_crosscity_raises_without_a_card(pair_and_city, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_crosscity.main(["--data_root_path", pair_and_city, "--checkpoint_dir",
                              str(tmp_path), "--iter_stop", "1", *SIZE, *COMMON])
