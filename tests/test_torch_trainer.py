"""The port's ``Trainer`` and ``UDATrainer`` (``train/trainer.py``,
``train/uda_trainer.py``) at ``blocks=(2,2,2,2)`` and tiny crops.

- Against the JAX trainers: 4 iterations and one validation on the same
  synthetic loaders from the same initial weights (JAX init, carried across
  by ``convert.state_dict_from_jax``): every per-iteration scalar within
  relative 1e-4 (fp32 through ~30 convs and their adjoints in another
  order) and the same mIoU.
- Port against port, modelled on ``tests/test_trainer.py``: a mid-epoch
  ``--save_iter`` resume and a SIGTERM checkpoint each reproduce the
  uninterrupted run exactly; ``--iter_stop``, also when resuming at it;
  ``--continue_training`` finds the run's latest checkpoint; every flag the
  port does not have raises; without a card and without ``--device cpu``
  the trainer raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from maxsquareloss_torch.config import (
    TrainConfig,
    add_train_args,
    add_uda_train_args,
    check_supported,
    config_from_args,
)
from maxsquareloss_torch.convert import state_dict_from_jax
from maxsquareloss_torch.data import synthetic as tsynthetic
from maxsquareloss_torch.data.loader import SegDataLoader
from maxsquareloss_torch.models import deeplabv2 as tmodel
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train.trainer import Trainer
from maxsquareloss_torch.train.uda_trainer import UDATrainer
from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
from maxsquareloss_tpu.data import loader as jloader
from maxsquareloss_tpu.data import synthetic as jsynthetic
from maxsquareloss_tpu.models import deeplabv2 as jmodel
from maxsquareloss_tpu.train.trainer import Trainer as JTrainer
from maxsquareloss_tpu.train.uda_trainer import UDATrainer as JUDATrainer

BLOCKS = (2, 2, 2, 2)
HW = (17, 33)
HEAD_SCALE = 40.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loader(n=8, batch=2, seed=0, port=True):
    mod = (tsynthetic, SegDataLoader) if port else (jsynthetic, jloader.SegDataLoader)
    return mod[1](mod[0].SyntheticSegDataset(length=n, hw=HW, seed=seed),
                  batch_size=batch, shuffle=True, num_workers=2, seed=seed)


def _cfg(run_dir, **kw):
    kw = {"blocks": BLOCKS, "epoch_num": 2, "iter_max": 100, "checkpoint_dir": str(run_dir),
          "num_workers": 2, "show_num_images": 1, "tqdm": False, "device": "cpu", **kw}
    return TrainConfig(**kw)


def _scalars(run_dir, prefix="train/"):
    out = {}
    for line in open(os.path.join(run_dir, "scalars.jsonl")):
        rec = json.loads(line)
        if rec["tag"].startswith(prefix) and rec["tag"] != "train/images_per_sec":
            out[(rec["tag"], rec["step"])] = rec["value"]
    return out


@pytest.fixture(scope="module")
def jax_weights():
    cfg = jmodel.DeepLabV2Config(num_classes=19, multi_level=True, blocks=BLOCKS)
    params, frozen = jmodel.init_deeplabv2(jax.random.key(0), cfg)
    params = jax.tree.map(np.array, params)
    for head in ("layer5", "layer6"):
        for conv in params[head]["convs"]:
            conv["w"] = conv["w"] * HEAD_SCALE
    return params, frozen


@pytest.mark.parametrize("uda", [False, True], ids=["supervised", "uda"])
def test_trainer_matches_jax(tmp_path, jax_weights, uda):
    params, frozen = jax_weights
    kw = {"iter_stop": 4, "epoch_num": 1, "threshold": 0.5}
    jcfg = JTrainConfig(blocks=BLOCKS, iter_max=100, checkpoint_dir=str(tmp_path / "jax"),
                        num_workers=2, show_num_images=1, tqdm=False, data_parallel=False, **kw)
    cfg = _cfg(tmp_path / "port", **kw)
    model = tmodel.DeepLabV2(tmodel.DeepLabV2Config(blocks=BLOCKS))
    model.load_state_dict(state_dict_from_jax(params, frozen))

    def loaders(port):
        train = (_loader(seed=0, port=port),) + ((_loader(seed=2, port=port),) if uda else ())
        return train, _loader(n=4, seed=3, port=port)

    (jtrain, jval), (ttrain, tval) = loaders(False), loaders(True)
    if uda:
        jt = JUDATrainer(jcfg, *jtrain, jval, params=params, frozen=frozen)
        tt = UDATrainer(cfg, *ttrain, tval, model=model)
    else:
        jt = JTrainer(jcfg, *jtrain, jval, params=params, frozen=frozen)
        tt = Trainer(cfg, *ttrain, tval, model=model)
    jt.train()
    tt.train()
    assert tt.state.iteration == int(np.asarray(jt.state.iteration)) == 4
    want, got = _scalars(tmp_path / "jax"), _scalars(tmp_path / "port")
    assert set(got) == set(want) and len({step for _, step in got}) == 4
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-4, atol=1e-7, err_msg=str(key))
    jval_m, tval_m = _scalars(tmp_path / "jax", "val/"), _scalars(tmp_path / "port", "val/")
    assert set(tval_m) == set(jval_m)
    assert tval_m[("val/MIoU", 4)] == jval_m[("val/MIoU", 4)]
    assert tt.best_miou == pytest.approx(jt.best_miou, abs=0)


def _losses(run_dir):
    return {step: v for (tag, step), v in _scalars(run_dir).items() if tag == "train/loss"}


@pytest.fixture(scope="module")
def truth(tmp_path_factory):
    """The uninterrupted run: 2 epochs x 4 batches, no validation."""
    run_dir = tmp_path_factory.mktemp("truth")
    Trainer(_cfg(run_dir, validation_epoch=100), _loader(n=8), None).train()
    losses = _losses(run_dir)
    assert set(losses) == set(range(1, 9))
    return losses


def test_mid_epoch_resume_is_exact(tmp_path, truth):
    class Preempted(KeyboardInterrupt):
        pass

    class DyingTrainer(Trainer):
        def _run_step(self, batch):
            if self.state.iteration == 2:
                raise Preempted()
            return super()._run_step(batch)

    with pytest.raises(Preempted):
        DyingTrainer(_cfg(tmp_path, validation_epoch=100, save_iter=1), _loader(n=8), None).train()
    tr = Trainer(_cfg(tmp_path, validation_epoch=100, continue_training=True,
                      pretrained_ckpt_file=str(tmp_path / ckpt_lib.LATEST)), _loader(n=8), None)
    tr.main()
    assert tr.state.iteration == 8
    resumed = _losses(tmp_path)
    for it in range(3, 9):
        assert resumed[it] == truth[it], f"iter {it} diverged"


def test_sigterm_checkpoints_and_resumes_exactly(tmp_path, truth):
    class SignalingTrainer(Trainer):
        def _run_step(self, batch):
            if self.state.iteration == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return super()._run_step(batch)

    before = signal.getsignal(signal.SIGTERM)
    tr = SignalingTrainer(_cfg(tmp_path, validation_epoch=100), _loader(n=8), None)
    tr.train()  # returns cleanly
    assert tr.preempted and tr.state.iteration == 3
    assert signal.getsignal(signal.SIGTERM) is before
    blob = ckpt_lib.load_checkpoint(str(tmp_path / ckpt_lib.LATEST))
    assert (blob["iteration"], blob["epoch"], blob["epoch_batch"]) == (3, 0, 3)
    # --continue_training alone: the run dir's latest checkpoint
    tr2 = Trainer(_cfg(tmp_path, validation_epoch=100, continue_training=True), _loader(n=8), None)
    tr2.main()
    assert not tr2.preempted and tr2.state.iteration == 8
    resumed = _losses(tmp_path)
    for it in range(4, 9):
        assert resumed[it] == truth[it], f"iter {it} diverged"


def test_preempt_save_false_keeps_default_sigterm(tmp_path):
    before = signal.getsignal(signal.SIGTERM)

    class Probing(Trainer):
        def _run_step(self, batch):
            assert signal.getsignal(signal.SIGTERM) is before
            return super()._run_step(batch)

    Probing(_cfg(tmp_path, epoch_num=1, iter_stop=1, preempt_save=False), _loader(), None).train()


def test_iter_stop_and_resume_at_it(tmp_path):
    Trainer(_cfg(tmp_path, epoch_num=10, iter_stop=3), _loader(), None).train()
    blob = ckpt_lib.load_checkpoint(str(tmp_path / ckpt_lib.LATEST))
    assert blob["iteration"] == 3 and blob["epoch_batch"] == 3  # mid-epoch stop
    tr2 = Trainer(_cfg(tmp_path, epoch_num=10, iter_stop=3, continue_training=True), _loader(), None)
    tr2.main()
    assert tr2.state.iteration == 3
    assert ckpt_lib.load_checkpoint(str(tmp_path / ckpt_lib.LATEST))["iteration"] == 3


def test_continue_training_defaults_to_latest_and_validates(tmp_path):
    tr = Trainer(_cfg(tmp_path, epoch_num=1), _loader(), _loader(n=4, seed=1))
    tr.train()
    assert tr.state.iteration == 4 and (tmp_path / ckpt_lib.LATEST).exists()
    tags = {tag for tag, _ in _scalars(tmp_path, "val/")}
    assert {"val/MIoU", "val/PA", "val/MPA", "val/FWIoU"} <= tags
    tr2 = Trainer(_cfg(tmp_path, epoch_num=2, continue_training=True), _loader(), None)
    tr2.main()
    assert tr2.state.iteration == 8 and tr2.current_epoch == 1
    assert tr2.best_miou == tr.best_miou


def test_pretrained_init_without_continue_starts_fresh(tmp_path):
    """A checkpoint as --pretrained_ckpt_file without --continue_training:
    its weights, a fresh optimizer, iteration 0 (the reference's rule)."""
    tr = Trainer(_cfg(tmp_path / "a", epoch_num=1, iter_stop=2), _loader(), None)
    tr.train()
    tr2 = Trainer(_cfg(tmp_path / "b", epoch_num=1, iter_stop=1,
                       pretrained_ckpt_file=str(tmp_path / "a" / ckpt_lib.LATEST)),
                  _loader(), None)
    tr2.load_checkpoint(tr2.cfg.pretrained_ckpt_file)
    assert tr2.state.iteration == 0 and not tr2.state.optimizer.state
    for k, v in tr2.model.state_dict().items():
        assert torch.equal(v, tr.model.state_dict()[k]), k


def test_synthia_protocol_reports_16_and_13(tmp_path):
    tr = Trainer(_cfg(tmp_path, epoch_num=1, iter_stop=1), _loader(n=2), _loader(n=2, seed=1),
                 synthia_protocol=True)
    tr.train()
    tags = {tag for tag, _ in _scalars(tmp_path, "val/")}
    assert {"val/MIoU_16", "val/MIoU_13"} <= tags


UNPORTED = [
    ("--quantize", "int8"), ("--loader", "grain"), ("--sp", "2"),
    ("--freeze_bn", "false"), ("--xla_options", "a=b"),
]


@pytest.mark.parametrize("flag,value", UNPORTED, ids=[f for f, _ in UNPORTED])
def test_unported_flags_raise(tmp_path, flag, value):
    import argparse

    p = argparse.ArgumentParser()
    add_uda_train_args(add_train_args(p))
    argv = ["--checkpoint_dir", str(tmp_path), flag] + ([value] if value is not None else [])
    with pytest.raises(NotImplementedError, match="not ported|XLA"):
        config_from_args(p.parse_args(argv))


def test_unported_field_raises_in_the_trainer(tmp_path):
    cfg = dataclasses.replace(_cfg(tmp_path), quantize="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, _loader(), None)


# the flags the bf16 slice ported, which raised before it
PORTED = [("--compute_dtype", "bfloat16"), ("--remat", "stages")]


@pytest.mark.parametrize("flag,value", PORTED, ids=[f for f, _ in PORTED])
def test_ported_flags_run_in_the_trainer(tmp_path, flag, value):
    """The flag parses, reaches the model (its compute dtype and remat) and
    trains an iteration with a validation; parameters stay float32."""
    p = argparse.ArgumentParser()
    add_uda_train_args(add_train_args(p))
    args = p.parse_args(["--checkpoint_dir", str(tmp_path), flag, value, "--device", "cpu"])
    cfg = dataclasses.replace(_cfg(tmp_path, iter_stop=1, epoch_num=1),
                              **{flag[2:]: getattr(args, flag[2:])})
    check_supported(config_from_args(args))
    tr = Trainer(cfg, _loader(n=2), _loader(n=2, seed=1))
    assert (tr.model.cfg.compute_dtype, tr.model.cfg.remat) == (cfg.dtype, cfg.remat)
    tr.train()
    assert tr.state.iteration == 1
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
    losses = list(_scalars(tmp_path, "train/loss").values())
    assert losses and all(np.isfinite(losses))


def test_data_parallel_on_one_device_is_accepted(tmp_path):
    import argparse

    p = add_train_args(argparse.ArgumentParser())
    cfg = config_from_args(p.parse_args(["--checkpoint_dir", str(tmp_path),
                                         "--data_parallel", "true", "--device", "cpu"]))
    assert cfg.data_parallel and cfg.device == "cpu"


def test_trainer_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_cfg(tmp_path, device=None), _loader(), None)
