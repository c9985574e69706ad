"""The port's CLIs end to end on the CPU (``--device cpu``, ``--blocks
2,2,2,2``) over a small on-disk ``write_domain_shift_pair`` fixture:
``train_source`` writes its checkpoint and ``scalars.jsonl``, then
``solve_gta5`` adapts from that checkpoint (it must start from the source
run's weights), validates and checkpoints; SYNTHIA → Cityscapes reports the
16/13-class protocol; without a card and without ``--device cpu`` a CLI
raises.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
from maxsquareloss_torch.tools import solve_gta5, train_source
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train.uda_trainer import UDATrainer

SIZE = ["--base_size", "64,32", "--crop_size", "64,32", "--target_base_size", "64,32",
        "--target_crop_size", "64,32"]
COMMON = ["--device", "cpu", "--blocks", "2,2,2,2", "--batch_size", "2", "--num_workers", "2",
          "--iter_max", "100", "--tqdm", "false", "--show_num_images", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("pair"))
    write_domain_shift_pair(base, n_source=6, n_target_train=6, n_target_val=4, hw=(32, 64))
    return base


def _tags(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return {json.loads(line)["tag"] for line in f}


def test_train_source_then_solve_gta5(tmp_path, data, monkeypatch):
    src_dir, uda_dir = str(tmp_path / "src"), str(tmp_path / "uda")
    trainer = train_source.main(["--dataset", "gta5", "--data_root_path", data,
                                 "--checkpoint_dir", src_dir, "--iter_stop", "3",
                                 *SIZE[:4], *COMMON])
    assert trainer.state.iteration == 3
    src_ckpt = os.path.join(src_dir, ckpt_lib.LATEST)
    assert os.path.exists(src_ckpt) and "train/loss" in _tags(src_dir)
    src_weights = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    started = {}
    train = UDATrainer.train

    def recording_train(self):
        started.update({k: v.clone() for k, v in self.model.state_dict().items()})
        started["_iteration"] = self.state.iteration
        return train(self)

    monkeypatch.setattr(UDATrainer, "train", recording_train)
    uda = solve_gta5.main(["--data_root_path", data, "--checkpoint_dir", uda_dir,
                           "--pretrained_ckpt_file", src_ckpt, "--iter_stop", "2",
                           "--threshold", "0.5", *SIZE, *COMMON])
    assert started.pop("_iteration") == 0  # a pretrained init, not a resume
    for k, v in src_weights.items():
        assert torch.equal(started[k], v), k
    assert uda.state.iteration == 2
    assert os.path.exists(os.path.join(uda_dir, ckpt_lib.LATEST))
    tags = _tags(uda_dir)
    assert {"train/loss", "train/loss_target", "train/iw_pixel_w_max", "val/MIoU"} <= tags
    blob = ckpt_lib.load_checkpoint(os.path.join(uda_dir, ckpt_lib.LATEST))
    # 3 batch pairs an epoch: iter_stop 2 checkpoints mid-epoch
    assert (blob["iteration"], blob["epoch"], blob["epoch_batch"]) == (2, 0, 2)
    assert np.isfinite(blob["best_MIou"])


def test_solve_synthia_reports_16_and_13(tmp_path, data):
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    from maxsquareloss_torch.data.synthia import SYNTHIA_ID_TO_TRAINID

    syn = tmp_path / "SYNTHIA"
    (syn / "RGB").mkdir(parents=True)
    (syn / "GT" / "LABELS").mkdir(parents=True)
    rng = np.random.default_rng(0)
    ids = list(SYNTHIA_ID_TO_TRAINID)
    names = [f"{i:07d}.png" for i in range(4)]
    for name in names:
        Image.fromarray(rng.integers(0, 255, (32, 64, 3)).astype(np.uint8)).save(syn / "RGB" / name)
        bgr = np.zeros((32, 64, 3), np.uint16)
        bgr[:, :, 2] = rng.choice(ids, (32, 64))
        assert cv2.imwrite(str(syn / "GT" / "LABELS" / name), bgr)
    (syn / "train.txt").write_text("\n".join(names))
    run_dir = str(tmp_path / "run")
    solve_gta5.main(["--source_dataset", "synthia", "--data_root_path", data,
                     "--source_data_path", str(syn), "--source_list_path", str(syn / "train.txt"),
                     "--checkpoint_dir", run_dir, "--iter_stop", "1", *SIZE, *COMMON])
    assert {"val/MIoU_16", "val/MIoU_13"} <= _tags(run_dir)


def test_cli_raises_without_a_card(tmp_path, data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data_root_path", data, "--checkpoint_dir", str(tmp_path), *SIZE,
            *[a for a in COMMON if a not in ("--device", "cpu")]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_gta5.main(argv)
