"""The port's benchmark entry point (``maxsquareloss_torch.bench`` and
``experiments/bench_e2e.py``) on the CPU at a tiny size: the JSON keys, the
JAX bench's metric names for the same flags, a finite loss, every
unported flag raising, the e2e legs at the scale of
``tests/test_bench_e2e.py``, ``ensure_dataset`` writing the JAX
harness's pixels, and both under ``torchrun --nproc_per_node 2`` (gloo)
against one process on the same global batch.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, ".")

from maxsquareloss_torch import bench
from maxsquareloss_torch.experiments import bench_e2e

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fp32 line (the bf16 default's own cases are in tests/test_torch_bf16.py)
TINY = ["--device", "cpu", "--blocks", "2,2,2,2", "--hw", "33,65", "--batch", "2",
        "--steps", "1", "--warmup", "1", "--dtype", "float32"]


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


UNPORTED = [["--quantize", "int8"], ["--xla_options", "auto"], ["--comparator", "15"]]


@pytest.mark.parametrize("flags", UNPORTED, ids=[f[0] for f in UNPORTED])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        bench.main([*TINY, *flags])


# the flags the bf16 slice ported, which raised before it
PORTED = [["--dtype", "bfloat16"], ["--remat", "stages"], ["--fp32_parity", "true"]]


@pytest.mark.parametrize("flags", PORTED, ids=[f[0] for f in PORTED])
def test_ported_flags_run(flags, capsys):
    """Each runs the fp32 line's ``source`` step (the cheapest train mode)
    with the flag taken: the compute dtype and remat in the JSON, and the
    parity leg's fields when it is asked for."""
    result = bench.main(["--mode", "source", *TINY, *flags])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result and result["value"] > 0
    extra = result["extra"]
    assert math.isfinite(extra["final_loss"])
    assert (extra["compute_dtype"], extra["remat"]) == (
        "bfloat16" if "bfloat16" in flags else "float32", "stages" if "stages" in flags else "")
    assert result["metric"].endswith(extra["compute_dtype"])
    if "--fp32_parity" in flags:
        assert extra["fp32_global_batch"] == 8 and extra["value_fp32_parity"] > 0
        assert math.isfinite(extra["fp32_final_loss"])
    else:
        assert "value_fp32_parity" not in extra


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


def _torchrun_two_ranks(target: list[str], tmp_path) -> subprocess.Popen:
    """``torchrun --standalone --nproc_per_node 2`` of ``target`` in the
    background, one torch thread a rank."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO,
           "TMPDIR": str(tmp_path)}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         *target], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _json_lines(proc: subprocess.Popen) -> list[dict]:
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-6000:]
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_two_rank_bench_matches_the_one_process_bench(tmp_path, capsys):
    """``torchrun --nproc_per_node 2 -m maxsquareloss_torch.bench --mode
    uda``: one JSON line, from rank 0, with ``chips`` 2 and the one-process
    run's final loss (the global batch's, after the same 3 steps)."""
    argv = ["--mode", "uda", *TINY]
    proc = _torchrun_two_ranks(["-m", "maxsquareloss_torch.bench", *argv], tmp_path)
    one = bench.main(argv)  # meanwhile, the one-process run
    lines = _json_lines(proc)
    assert len(lines) == 1, lines
    (two,) = lines
    assert two["metric"] == one["metric"] and two["unit"] == "images/sec/chip"
    assert two["value"] > 0 and two["extra"]["value_infer_fp32"] > 0
    assert (two["extra"]["chips"], two["extra"]["global_batch"]) == (2, 2)
    assert one["extra"]["chips"] == 1
    np.testing.assert_allclose(two["extra"]["final_loss"], one["extra"]["final_loss"],
                               rtol=1e-5)


_E2E_RANK = """
import json, sys, types
from maxsquareloss_torch.experiments import bench_e2e
from maxsquareloss_torch.parallel import ddp, multihost

multihost.initialize_distributed("cpu")
result = bench_e2e.run_e2e(types.SimpleNamespace(**json.loads(sys.argv[1])))
if ddp.is_main():
    print(json.dumps(result))
ddp.shutdown()
"""


def test_two_rank_e2e_matches_the_one_process_e2e(tmp_path):
    """``run_e2e`` under ``torchrun --nproc_per_node 2`` at the CPU scale:
    rank 0 writes the dataset and the prepared roots behind barriers, each
    rank loads its shard of every global batch, ``chips`` is 2, rank 0
    counts its own images, and the cold leg's final loss is the one-process
    run's."""
    script = tmp_path / "e2e_rank.py"
    script.write_text(_E2E_RANK)
    two_args = vars(_e2e_args(tmp_path, data_root=str(tmp_path / "two" / "data")))
    proc = _torchrun_two_ranks([str(script), json.dumps(two_args)], tmp_path)
    one = bench_e2e.run_e2e(_e2e_args(tmp_path, data_root=str(tmp_path / "one" / "data")))
    lines = _json_lines(proc)
    assert len(lines) == 1, lines
    (two,) = lines
    assert two["metric"] == one["metric"]
    assert (two["extra"]["chips"], one["extra"]["chips"]) == (2, 1)
    assert two["extra"]["global_batch"] == one["extra"]["global_batch"] == 4
    assert two["extra"]["epoch_images"] * 2 == one["extra"]["epoch_images"] == 16
    for leg in ("cold", "warm", "prepared", "prepared_raw"):
        assert two["extra"][f"e2e_{leg}_imgs_per_sec"] > 0
    for leg in ("prepared", "prepared_raw"):  # rank 0 wrote them
        assert os.path.isdir(tmp_path / "two" / f"data_{leg}")
    np.testing.assert_allclose(two["extra"]["final_loss"], one["extra"]["final_loss"],
                               rtol=1e-5)
