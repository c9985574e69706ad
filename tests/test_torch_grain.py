"""``--loader grain``: the port's ``GrainSegLoader`` against the JAX
package's and against the port's ``SegDataLoader``.

Batches are bitwise the JAX grain loader's over two epochs, shuffled or
not, over shards (train's equal lengths, val's padded shards), pad slots
and ``set_skip``. Against the thread loader: the same batches when
unshuffled, and when shuffled every sample equal under its name (the same
``(seed, epoch, key)`` draws). A port CLI trains 2 iterations with it, and
without the grain package the flag raises ``ImportError``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from maxsquareloss_torch.config import add_train_args, config_from_args
from maxsquareloss_torch.data import grain_pipeline
from maxsquareloss_torch.data.grain_pipeline import GrainSegLoader
from maxsquareloss_torch.data.loader import SegDataLoader
from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
from maxsquareloss_tpu.data import grain_pipeline as jax_grain

pytest.importorskip("grain.python")

HW = (4, 6)


class DrawDataset:
    """Samples that depend on their index and on their augmentation draws."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def get(self, index: int, rng: np.random.Generator):
        x = np.float32(index) + rng.random((*HW, 3), dtype=np.float32)
        y = rng.integers(-1, 19, HW).astype(np.int32)
        return x, y, f"s{index:03d}"


def _epochs(loader, epochs=2, skip=0):
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        if skip:
            loader.set_skip(skip)
        out.append(list(loader))
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (xa, ya, na), (xb, yb, nb) in zip(ea, eb):
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype and list(na) == list(nb)
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


CASES = {
    "shuffled": dict(n=12, batch_size=4, shuffle=True),
    "unshuffled": dict(n=12, batch_size=4, shuffle=False),
    "remainder_dropped": dict(n=11, batch_size=4, shuffle=True),
    "train_shard_1_of_3": dict(n=10, batch_size=2, shuffle=True, shard_index=1, shard_count=3),
    "val_padded_shard_2_of_3": dict(n=10, batch_size=2, shuffle=False, drop_last=False,
                                    pad_last=True, shard_index=2, shard_count=3),
    "val_pad_slots": dict(n=5, batch_size=4, shuffle=False, drop_last=False, pad_last=True),
    "skip_1": dict(n=12, batch_size=4, shuffle=True, skip=1),
    "skip_1_sharded_padded": dict(n=10, batch_size=2, shuffle=True, drop_last=False,
                                  pad_last=True, shard_index=1, shard_count=3, skip=1),
}


def _pair(cls_a, cls_b, case, workers_b=0):
    kw = dict(CASES[case])
    n, skip = kw.pop("n"), kw.pop("skip", 0)
    a = cls_a(DrawDataset(n), num_workers=0, seed=5, **kw)
    b = cls_b(DrawDataset(n), num_workers=workers_b, seed=5, **kw)
    return a, b, skip


@pytest.mark.parametrize("case", list(CASES))
def test_batches_equal_the_jax_grain_loader(case):
    port, ref, skip = _pair(GrainSegLoader, jax_grain.GrainSegLoader, case)
    assert port.num_iterations == ref.num_iterations == len(port)
    _assert_same(_epochs(port, skip=skip), _epochs(ref, skip=skip))


@pytest.mark.parametrize("case", ["unshuffled", "val_padded_shard_2_of_3", "val_pad_slots"])
def test_unshuffled_batches_equal_the_thread_loader(case):
    port, threads, skip = _pair(GrainSegLoader, SegDataLoader, case, workers_b=2)
    assert port.num_iterations == threads.num_iterations
    _assert_same(_epochs(port, skip=skip), _epochs(threads, skip=skip))


def test_shuffled_samples_equal_the_thread_loaders_by_name():
    """The shuffles differ (grain's sampler, numpy's permutation); each epoch
    holds the same samples, each the same bits under its name, and the next
    epoch reshuffles."""
    port, threads, _ = _pair(GrainSegLoader, SegDataLoader, "shuffled", workers_b=2)
    ga, gb = _epochs(port), _epochs(threads)
    for ea, eb in zip(ga, gb):
        by_name = {n: (x, y) for xs, ys, ns in eb for x, y, n in zip(xs, ys, ns)}
        names = [n for _, _, ns in ea for n in ns]
        assert sorted(names) == sorted(by_name)
        for xs, ys, ns in ea:
            for x, y, n in zip(xs, ys, ns):
                assert np.array_equal(x, by_name[n][0]) and np.array_equal(y, by_name[n][1])
    assert [n for b in ga[0] for n in b[2]] != [n for b in ga[1] for n in b[2]]


def test_set_skip_gives_the_tail_without_decoding_the_head():
    ds = DrawDataset(12)
    loader = GrainSegLoader(ds, batch_size=4, num_workers=0, seed=5, shuffle=True)
    full = list(loader)
    decoded = []
    get = ds.get
    ds.get = lambda i, rng: (decoded.append(i), get(i, rng))[1]
    loader.set_epoch(0)
    loader.set_skip(2)
    tail = list(loader)
    _assert_same([full[2:]], [tail])
    assert sorted(decoded) == sorted(int(n[1:]) for n in full[2][2])
    loader.set_epoch(0)
    loader.set_skip(3)
    assert list(loader) == []


def test_without_grain_the_flag_raises(monkeypatch):
    from maxsquareloss_torch.tools.common import make_loader

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "grain" else find_spec(name, *a))
    with pytest.raises(ImportError, match="needs the grain package"):
        grain_pipeline.GrainSegLoader(DrawDataset(4), batch_size=2)
    p = argparse.ArgumentParser()
    add_train_args(p)
    cfg = config_from_args(p.parse_args(["--checkpoint_dir", "/nonexistent",
                                         "--loader", "grain"]))  # the CLI takes it
    assert cfg.loader == "grain"
    with pytest.raises(ImportError, match="--loader grain"):
        make_loader(cfg, "gta5", "/nonexistent", os.devnull, "train")


@pytest.fixture
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_trains_with_the_grain_loader(tmp_path, _one_torch_thread):
    from maxsquareloss_torch.tools import train_source

    data = str(tmp_path / "pair")
    write_domain_shift_pair(data, n_source=4, n_target_train=2, n_target_val=2, hw=(128, 256))
    run = str(tmp_path / "run")
    trainer = train_source.main([
        "--dataset", "gta5", "--data_root_path", data, "--checkpoint_dir", run,
        "--loader", "grain", "--num_workers", "0", "--device", "cpu", "--blocks", "1,1,1,1",
        "--base_size", "256,128", "--crop_size", "256,128", "--batch_size", "2",
        "--iter_max", "100", "--iter_stop", "2", "--tqdm", "false"])
    assert isinstance(trainer.train_loader, GrainSegLoader)
    assert trainer.state.iteration == 2
    with open(os.path.join(run, "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if json.loads(line)["tag"] == "train/loss"]
    assert losses and all(np.isfinite(losses))
