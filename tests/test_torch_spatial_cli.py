"""The serving CLIs under ``--sp`` on the CPU: ``tools.evaluate --sp 2`` and
``tools.predict --sp 2`` as two gloo processes (``torchrun``), and
``evaluate --sp 2`` as dp2 x sp2 over four, each against the same CLI in
one process on the same ``.pth`` and data. The launches start together;
the one-process runs go meanwhile in this process.

- evaluate: scales 0.75,1.0 + flip, ``--full_res_labels`` (labels at the
  files' native size, taller than the base size), ``--eval_h_chunk 7``
  (not a divisor of a shard): every printed metric within 1e-4 of the one
  process's (the readings are 0);
- predict: the same TTA at the files' native size: the trainId PNGs equal
  on >= 99.9 % of the pixels (the reading is every pixel), the colour PNGs
  written by rank 0 alone;
- ``solve_gta5 --sp 2`` as two gloo processes (``torchrun``): 2 iterations,
  a validation and a checkpoint, its losses and its parameters against the
  one-process run on the same ``.pth`` and data (the step tolerance of
  ``tests/test_torch_ddp.py``: losses rtol 1e-5, parameter changes 1e-4
  relative L2);
- what still raises, as in the JAX package: ``--sp`` with ``--quantize
  int8``, in the trainers and the export (``--sp`` with
  ``--concat_batches`` or ``--remat stages``: ``tests/
  test_torch_spatial_options_cli.py``; the export's ``--sp``: ``tests/
  test_torch_spatial_export.py``).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
from maxsquareloss_torch.optim import make_sgd
from maxsquareloss_torch.tools import evaluate, predict
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train.steps import model_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = "2,2,2,2"
FILE_HW = (36, 72)  # native size on disk; the base size is 64x32 (W, H)
TTA = ["--scales", "0.75,1.0", "--flip", "true", "--eval_h_chunk", "7"]
# name: (CLI, processes, flags)
RUNS = {
    "evaluate_sp2": ("evaluate", 2, ["--full_res_labels", "true"]),
    "evaluate_dp2xsp2": ("evaluate", 4, []),
    "predict_sp2": ("predict", 2, []),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(datasets root, .pth path): 5 val images (padded last batches)."""
    base = tmp_path_factory.mktemp("serve_sp")
    data = str(base / "data")
    write_domain_shift_pair(data, n_source=1, n_target_train=1, n_target_val=5, hw=FILE_HW)
    cfg = TrainConfig(blocks=tuple(int(b) for b in BLOCKS.split(",")))
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(7), device="cpu")
    path = ckpt_lib.save_checkpoint(str(base / "ckpt"), model, make_sgd(model, cfg), 0, 0, 0.0)
    return data, path, base


def _argv(served, run_dir, cli, flags):
    data, path, _ = served
    out = ["--output_dir", run_dir] if cli == "predict" else []
    return ["--dataset", "cityscapes", "--data_root_path", data, "--checkpoint_dir", run_dir,
            "--pretrained_ckpt_file", path, "--base_size", "64,32", "--crop_size", "64,32",
            "--blocks", BLOCKS, "--batch_size", "2", "--num_workers", "1", "--tqdm", "false",
            "--device", "cpu", *TTA, *flags, *out]


@pytest.fixture(scope="module")
def runs(served):
    """{run: (its torchrun output, its directory, the one-process result and
    directory)}."""
    base = served[2]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = {}
    for name, (cli, nproc, flags) in RUNS.items():
        argv = _argv(served, str(base / name), cli, [*flags, "--sp", "2"])
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(nproc), "-m", f"maxsquareloss_torch.tools.{cli}", *argv],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {}
        for name, (cli, _, flags) in RUNS.items():
            key = (cli, tuple(flags))
            if key not in one:
                run_dir = str(base / f"one_{name}")
                one[key] = ({"evaluate": evaluate, "predict": predict}[cli].main(
                    _argv(served, run_dir, cli, flags)), run_dir)
        for name, proc in procs.items():
            text = proc.communicate(timeout=300)[0]
            assert proc.returncode == 0, text[-6000:]
            cli, _, flags = RUNS[name]
            out[name] = (text, str(base / name), *one[(cli, tuple(flags))])
    finally:
        torch.set_num_threads(threads)
        for proc in procs.values():
            proc.kill()
    return out


def _printed_dicts(text: str) -> list[dict[str, float]]:
    return [{k: float(v) for k, v in re.findall(r"'(\w+)': (?:np\.float64\()?([-0-9.eE+na]+)",
                                                 line)}
            for line in text.splitlines() if line.startswith("{'PA'")]


@pytest.mark.parametrize("name", ["evaluate_sp2", "evaluate_dp2xsp2"])
def test_evaluate_sp_prints_the_one_process_metrics(runs, name):
    text, _, one, _ = runs[name]
    printed = _printed_dicts(text)
    assert len(printed) == 1, "rank 0 alone prints the metrics"
    assert set(printed[0]) == {"PA", "MPA", "MIoU", "FWIoU"}
    for k, v in printed[0].items():
        assert abs(v - one[k]) <= 1e-4, (k, v, one[k])


def test_predict_sp_writes_the_one_process_trainids(runs):
    _, run_dir, n_one, one_dir = runs["predict_sp2"]
    names = sorted(f for f in os.listdir(one_dir) if f.endswith("_trainids.png"))
    assert n_one == len(names) == 5
    assert sorted(f for f in os.listdir(run_dir) if f.endswith(".png")) == sorted(
        f for f in os.listdir(one_dir) if f.endswith(".png"))
    differ = total = 0
    for name in names:
        got = np.asarray(Image.open(os.path.join(run_dir, name)))
        want = np.asarray(Image.open(os.path.join(one_dir, name)))
        assert got.shape == want.shape == FILE_HW
        differ += int((got != want).sum())
        total += got.size
    assert differ <= 1e-3 * total, f"{differ} of {total} trainIds differ"


@pytest.mark.parametrize("cli", ["train_source", "solve_gta5", "export_inference"])
def test_trainers_and_the_export_still_refuse_sp(tmp_path, served, cli, monkeypatch):
    """With ``--quantize int8`` (the refusal the JAX package has too); the
    trainers take ``--sp`` with ``--concat_batches`` and ``--remat``, and
    the export takes ``--sp``, so the flags ride along."""
    import importlib

    module = importlib.import_module(f"maxsquareloss_torch.tools.{cli}")
    monkeypatch.setenv("WORLD_SIZE", "2")  # a space group of 2 is two processes
    if cli == "export_inference":
        argv = ["--pretrained_ckpt_file", served[1], "--output", str(tmp_path / "m"),
                "--blocks", BLOCKS, "--device", "cpu", "--hw", "32,64", "--sp", "2"]
    else:
        argv = ["--data_root_path", served[0], "--checkpoint_dir", str(tmp_path),
                "--device", "cpu", "--blocks", BLOCKS, "--sp", "2", "--concat_batches", "true",
                "--remat", "stages"]
    with pytest.raises(ValueError, match="does not compose with --sp 2") as err:
        module.main([*argv, "--quantize", "int8"])
    assert "JAX" in str(err.value)


def _rel_l2_changes(got: dict, want: dict, start: dict) -> dict:
    out = {}
    for name, w in want.items():
        change = w.detach().double() - start[name].detach().double()
        out[name] = float(((got[name].detach().double() - start[name].detach().double())
                           - change).norm() / change.norm())
    return out


def test_solve_gta5_sp2_matches_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m maxsquareloss_torch.tools.solve_gta5
    --sp 2 --device cpu``: one space group of two gloo ranks, 2 iterations
    of global batch 2, a validation (the SP eval step) and a checkpoint by
    rank 0; its losses and weights within the step tolerance of the
    one-process run from the same ``.pth``."""
    from maxsquareloss_torch.convert import reference_state_dict
    from maxsquareloss_torch.models.deeplabv2 import DeepLabV2Config
    from maxsquareloss_torch.tools import solve_gta5

    data = str(tmp_path / "data")
    write_domain_shift_pair(data, n_source=4, n_target_train=4, n_target_val=3, hw=(32, 64))
    blocks = tuple(int(b) for b in BLOCKS.split(","))
    start = init_deeplabv2(DeepLabV2Config(blocks=blocks), torch.Generator().manual_seed(0),
                           device="cpu")
    torch.save({"state_dict": reference_state_dict(start)}, tmp_path / "init.pth")
    size = ["--base_size", "64,32", "--crop_size", "64,32", "--target_base_size", "64,32",
            "--target_crop_size", "64,32"]
    common = ["--data_root_path", data, "--device", "cpu", "--blocks", BLOCKS,
              "--batch_size", "2", "--num_workers", "1", "--iter_max", "100",
              "--iter_stop", "2", "--tqdm", "false", "--iw_hist", "argmax",
              "--pretrained_ckpt_file", str(tmp_path / "init.pth"), *size]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "maxsquareloss_torch.tools.solve_gta5", *common, "--sp", "2",
         "--checkpoint_dir", str(tmp_path / "sp2")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = solve_gta5.main([*common, "--checkpoint_dir", str(tmp_path / "one")])
        out = proc.communicate(timeout=300)[0]
    finally:
        torch.set_num_threads(threads)
        proc.kill()
    assert proc.returncode == 0, out[-6000:]

    def scalars(run):
        with open(tmp_path / run / "scalars.jsonl") as f:
            return [json.loads(line) for line in f]

    sp_s, one_s = scalars("sp2"), scalars("one")
    assert [(r["tag"], r["step"]) for r in sp_s] == [(r["tag"], r["step"]) for r in one_s]
    assert {"train/loss", "val/MIoU"} <= {r["tag"] for r in sp_s}
    for a, b in zip(sp_s, one_s):
        if a["tag"].startswith("train/") and a["tag"] != "train/images_per_sec":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-5, atol=1e-7,
                                       err_msg=a["tag"])
        elif a["tag"].startswith("val/"):
            assert abs(a["value"] - b["value"]) <= 1e-4, (a["tag"], a["value"], b["value"])
    sp2 = ckpt_lib.load_checkpoint(str(tmp_path / "sp2" / ckpt_lib.LATEST))
    assert sp2["iteration"] == 2
    one_params = {n: p.detach().clone() for n, p in one.model.named_parameters()}
    ckpt_lib.load_weights(one.model, sp2, 19)
    errs = _rel_l2_changes(dict(one.model.named_parameters()), one_params,
                           dict(start.named_parameters()))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, f"{worst}: change off by {errs[worst]:.3g} (relative L2)"
