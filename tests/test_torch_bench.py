"""The port's benchmark entry point (``maxsquareloss_torch.bench`` and
``experiments/bench_e2e.py``) on the CPU at a tiny size: the JSON keys, the
JAX bench's metric names for the same flags, a finite loss, every
unported flag raising, the e2e legs at the scale of
``tests/test_bench_e2e.py``, and ``ensure_dataset`` writing the JAX
harness's pixels.
"""

from __future__ import annotations

import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, ".")

from maxsquareloss_torch import bench
from maxsquareloss_torch.experiments import bench_e2e

TINY = ["--device", "cpu", "--blocks", "2,2,2,2", "--hw", "33,65", "--batch", "2",
        "--steps", "1", "--warmup", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check_common(result, capsys):
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert result["unit"] == "images/sec/chip" and result["value"] > 0
    assert "vs_baseline" not in result
    extra = result["extra"]
    assert math.isfinite(extra["final_loss"])
    assert len(extra["step_ms_passes"]) == 2 and extra["step_ms"] == min(extra["step_ms_passes"])
    assert extra["value_fp32"] == result["value"]
    assert (extra["platform"], extra["device_kind"], extra["chips"]) == ("cpu", "cpu", 1)
    assert extra["peak_memory_bytes"] is None
    assert not any("comparator" in k for k in extra)
    return extra


@pytest.mark.parametrize("mode", ["uda", "source"])
def test_train_modes(mode, capsys):
    result = bench.main(["--mode", mode, *TINY])
    extra = _check_common(result, capsys)
    assert result["metric"] == f"{mode}_train_images_per_sec_per_chip_65x33_float32"
    assert extra["iw_hist"] == "argmax"
    if mode == "uda":  # with_infer defaults on for uda
        assert extra["value_infer_fp32"] > 0 and extra["infer_step_ms"] > 0
        assert extra["infer_label_hw"] == "33,65"
    else:
        assert "value_infer_fp32" not in extra


@pytest.mark.parametrize("label_hw", ["", "66,130"], ids=["input_size", "larger_labels"])
def test_infer_mode(label_hw, capsys):
    argv = ["--mode", "infer", *TINY, "--scales", "0.75,1.0", "--flip", "true"]
    result = bench.main(argv + (["--label_hw", label_hw] if label_hw else []))
    extra = _check_common(result, capsys)
    assert result["metric"] == "infer_images_per_sec_per_chip_65x33_float32"
    assert extra["label_hw"] == (label_hw or "33,65") and extra["flip"] is True
    assert "value_infer_fp32" not in extra


UNPORTED = [
    ["--dtype", "bfloat16"], ["--remat", "stages"], ["--concat"], ["--quantize", "int8"],
    ["--fp32_parity", "true"], ["--xla_options", "auto"], ["--comparator", "15"],
]


@pytest.mark.parametrize("flags", UNPORTED, ids=[f[0] for f in UNPORTED])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        bench.main([*TINY, *flags])


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([a for a in TINY if a not in ("--device", "cpu")])


def _e2e_args(tmp_path, **kw):
    """The scale of tests/test_bench_e2e.py."""
    d = dict(data_root=str(tmp_path / "data"), num_workers=2, epochs=1, batch=4,
             dtype="float32", device="cpu", blocks=(1, 1, 2, 1), n_per_domain=8,
             src_disk_wh=(256, 144), tgt_disk_wh=(256, 128), base_size=(128, 72),
             crop_size=(128, 72), target_base_size=(128, 64), target_crop_size=(128, 64))
    d.update(kw)
    return types.SimpleNamespace(**d)


def test_e2e_legs(tmp_path):
    result = bench_e2e.run_e2e(_e2e_args(tmp_path))
    assert result["metric"] == "e2e_uda_images_per_sec_per_chip_src128x72_tgt128x64_float32"
    assert result["unit"] == "images/sec/chip" and result["value"] > 0
    extra = result["extra"]
    assert extra["epoch_images"] == 16  # floor(8 / 4) * 2 steps * (4 + 4) images
    for leg in ("cold", "warm", "prepared", "prepared_raw"):
        assert extra[f"e2e_{leg}_imgs_per_sec"] > 0
        assert extra[f"e2e_{leg}_epoch_rates"] == [extra[f"e2e_{leg}_imgs_per_sec"]]
    assert extra["device_only_imgs_per_sec"] > 0 and extra["timed_epochs_each"] == 1
    assert extra["h2d_MB_per_sec"] is None and extra["h2d_MB_per_step"] > 0
    assert extra["device_normalize"] is True and math.isfinite(extra["final_loss"])
    assert result["value"] == extra["e2e_warm_imgs_per_sec"]
    json.dumps(result)


def test_ensure_dataset_matches_jax_and_is_reused(tmp_path):
    from experiments.bench_e2e import ensure_dataset as jensure

    kw = dict(n=2, src_wh=(64, 40), tgt_wh=(72, 32))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    bench_e2e.ensure_dataset(port, **kw)
    jensure(ref, **kw)
    files = sorted(os.path.relpath(os.path.join(d, n), port)
                   for d, _, names in os.walk(port) for n in names)
    assert len(files) == 4 * 2 + 3  # 2 domains x 2 pairs x (image, label), lists, stamp
    for rel in files:
        a, b = os.path.join(port, rel), os.path.join(ref, rel)
        if rel.endswith(".png"):
            assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b))), rel
        else:
            assert open(a).read() == open(b).read(), rel
    probe = os.path.join(port, "GTA5", "images", "00000.png")
    mtime = os.path.getmtime(probe)
    bench_e2e.ensure_dataset(port, **kw)
    assert os.path.getmtime(probe) == mtime  # the stamp matched: nothing rewritten
    bench_e2e.ensure_dataset(port, n=3, src_wh=kw["src_wh"], tgt_wh=kw["tgt_wh"])
    assert os.path.exists(os.path.join(port, "GTA5", "images", "00002.png"))
