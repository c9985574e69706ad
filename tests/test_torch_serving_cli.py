"""The port's serving CLIs against the JAX package's, from one ``.pth``.

A seeded small-depth model is written once with the port's
``train/checkpoint``; the port's ``tools.evaluate`` and the JAX
``tools/evaluate.main`` (which reads the file through
``load_inference_params``) evaluate it over the same tiny Cityscapes-layout
val split, and every key of the printed metric dict must agree within 1e-6
absolute. The port's ``tools.predict`` and the JAX ``tools/predict.main``
write trainId PNGs that must agree on at least 99.9 % of the pixels (the
count that differs is reported; it is expected to be 0), and each colour PNG
is bitwise ``decode_labels`` of its trainIds. With ``--quantize int8``
both packages calibrate and quantize (the ranges over the first
``--calib_batches`` batches, amax or a percentile): the metrics agree
within 1e-4 and the trainIds on at least 99.9 % of the pixels (an
activation one float32 ulp off a rounding boundary of the int8 grid moves
one input by one step). ``--sp 2`` in one process raises (a space group of
2 needs 2 processes: ``tests/test_torch_spatial_cli.py`` runs them), and
without a card and without ``--device cpu`` the CLIs raise.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, ".")

from maxsquareloss_torch.data.palette import decode_labels
from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
from maxsquareloss_torch.optim import make_sgd
from maxsquareloss_torch.tools import evaluate, predict
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train.steps import model_config
from maxsquareloss_torch.config import TrainConfig

BLOCKS = "2,2,2,2"
FILE_HW = (36, 72)  # native size on disk; base size below is 64x32 (W, H)
SIZE = ["--base_size", "64,32", "--crop_size", "64,32"]
SHARED = ["--blocks", BLOCKS, "--batch_size", "2", "--num_workers", "2", "--tqdm", "false",
          "--compilation_cache_dir", ""]
PORT = ["--device", "cpu"]
JAX = ["--data_parallel", "false"]  # one device of the 8-device CPU mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(datasets root, .pth path): 5 val images (a padded last batch)."""
    base = tmp_path_factory.mktemp("serve")
    data = str(base / "data")
    write_domain_shift_pair(data, n_source=1, n_target_train=1, n_target_val=5, hw=FILE_HW)
    cfg = TrainConfig(blocks=tuple(int(b) for b in BLOCKS.split(",")))
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(7), device="cpu")
    ckpt_dir = str(base / "ckpt")
    path = ckpt_lib.save_checkpoint(ckpt_dir, model, make_sgd(model, cfg), 0, 0, 0.0)
    return data, path


def _argv(served, run_dir, extra):
    data, path = served
    return ["--dataset", "cityscapes", "--data_root_path", data, "--checkpoint_dir", run_dir,
            "--pretrained_ckpt_file", path, *SIZE, *SHARED, *extra]


def _printed_dict(text: str) -> dict[str, float]:
    line = [ln for ln in text.splitlines() if ln.startswith("{'")][-1]
    return {k: float(v) for k, v in re.findall(r"'(\w+)': ([^,}]+)", line)}


EVAL_CASES = {
    "single_scale": [],
    "multiscale_flip": ["--scales", "0.75,1.0", "--flip", "true"],
    "full_res_labels": ["--full_res_labels", "true"],
    "class_16": ["--class_16", "true"],
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluate_prints_the_jax_metrics(served, tmp_path, capsys, case):
    from tools import evaluate as jevaluate

    extra = EVAL_CASES[case]
    out = evaluate.main(_argv(served, str(tmp_path / "port"), [*extra, *PORT]))
    port_printed = _printed_dict(capsys.readouterr().out)
    jevaluate.main(_argv(served, str(tmp_path / "jax"), [*extra, *JAX]))
    jax_printed = _printed_dict(capsys.readouterr().out)

    assert port_printed == pytest.approx(out, abs=0)  # the dict main returns is the printed one
    want_keys = {"PA", "MPA", "MIoU", "FWIoU"} | ({"MIoU_16", "MIoU_13"} if case == "class_16"
                                                   else set())
    assert set(port_printed) == set(jax_printed) == want_keys
    for k, v in jax_printed.items():
        assert np.isfinite(port_printed[k]) and abs(port_printed[k] - v) <= 1e-6, (
            k, port_printed[k], v)


@pytest.mark.parametrize("native", [True, False], ids=["native_size", "base_size"])
def test_predict_writes_the_jax_trainids(served, tmp_path, native):
    from tools import predict as jpredict

    flags = ["--scales", "0.75,1.0", "--flip", "true", "--native_size_output", str(native)]
    dirs = {side: str(tmp_path / side) for side in ("port", "jax")}
    n = predict.main(_argv(served, str(tmp_path / "run_port"),
                           ["--output_dir", dirs["port"], *flags, *PORT]))
    jpredict.main(_argv(served, str(tmp_path / "run_jax"),
                        ["--output_dir", dirs["jax"], *flags, *JAX]))
    names = sorted(f for f in os.listdir(dirs["jax"]) if f.endswith(".png"))
    assert n == 5 and sorted(f for f in os.listdir(dirs["port"]) if f.endswith(".png")) == names
    want_hw = FILE_HW if native else (32, 64)
    differ = total = 0
    for name in (f for f in names if f.endswith("_trainids.png")):
        port = np.asarray(Image.open(os.path.join(dirs["port"], name)))
        jax_ids = np.asarray(Image.open(os.path.join(dirs["jax"], name)))
        assert port.shape == jax_ids.shape == want_hw and port.dtype == np.uint8
        assert set(np.unique(port)) <= set(range(19)) | {255}
        differ += int((port != jax_ids).sum())
        total += port.size
        color = np.asarray(Image.open(os.path.join(dirs["port"],
                                                   name.replace("_trainids", "_color"))))
        ids = np.where(port == 255, -1, port).astype(np.int32)
        assert np.array_equal(color, decode_labels(ids[None])[0])
    assert differ <= 1e-3 * total, f"{differ} of {total} trainIds differ from the JAX CLI's"


INT8 = ["--quantize", "int8", "--calib_batches", "2"]


@pytest.mark.parametrize("calib_mode", ["amax", "p99.9"])
def test_evaluate_int8_prints_the_jax_metrics(served, tmp_path, capsys, calib_mode):
    """``--quantize int8``: both CLIs calibrate on the first 2 val batches and
    evaluate the int8 model; the metrics within 1e-4."""
    from tools import evaluate as jevaluate

    extra = [*INT8, "--calib_mode", calib_mode]
    evaluate.main(_argv(served, str(tmp_path / "port"), [*extra, *PORT]))
    port_printed = _printed_dict(capsys.readouterr().out)
    jevaluate.main(_argv(served, str(tmp_path / "jax"), [*extra, *JAX]))
    jax_printed = _printed_dict(capsys.readouterr().out)
    assert set(port_printed) == set(jax_printed) == {"PA", "MPA", "MIoU", "FWIoU"}
    for k, v in jax_printed.items():
        assert abs(port_printed[k] - v) <= 1e-4, (k, port_printed[k], v)


def test_predict_int8_writes_the_jax_trainids(served, tmp_path):
    from tools import predict as jpredict

    dirs = {side: str(tmp_path / side) for side in ("port", "jax")}
    predict.main(_argv(served, str(tmp_path / "run_port"),
                       ["--output_dir", dirs["port"], *INT8, *PORT]))
    jpredict.main(_argv(served, str(tmp_path / "run_jax"),
                        ["--output_dir", dirs["jax"], *INT8, *JAX]))
    names = sorted(f for f in os.listdir(dirs["jax"]) if f.endswith("_trainids.png"))
    assert len(names) == 5
    differ = total = 0
    for name in names:
        port = np.asarray(Image.open(os.path.join(dirs["port"], name)))
        jax_ids = np.asarray(Image.open(os.path.join(dirs["jax"], name)))
        differ += int((port != jax_ids).sum())
        total += port.size
    assert differ <= 1e-3 * total, f"{differ} of {total} trainIds differ from the JAX CLI's"


@pytest.mark.parametrize("cli", ["evaluate", "predict"])
def test_sp_raises(served, tmp_path, cli):
    extra = ["--sp", "2", *PORT] + (["--output_dir", str(tmp_path / "out")] if cli == "predict"
                                    else [])
    with pytest.raises(ValueError, match="--sp 2 does not divide the 1 process"):
        {"evaluate": evaluate, "predict": predict}[cli].main(
            _argv(served, str(tmp_path / "run"), extra))


@pytest.mark.parametrize("cli", ["evaluate", "predict"])
def test_cli_raises_without_a_card(served, tmp_path, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = ["--output_dir", str(tmp_path / "out")] if cli == "predict" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"evaluate": evaluate, "predict": predict}[cli].main(
            _argv(served, str(tmp_path / "run"), extra))
