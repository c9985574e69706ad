"""Stage remat (``--remat stages``) and the entry points in bf16
(``--compute_dtype bfloat16``) on the CPU at small sizes: remat against no
remat, bitwise on the CPU (the same ops run again), fp32 and bf16,
supervised, UDA and ``--concat_batches``, and every identity block
recomputed once; ``solve_gta5`` in bf16 with remat, its fp32 reference
checkpoint, ``evaluate`` and ``predict`` from it, an exact resume; the
bench's default bf16 line with its fp32 parity leg and the e2e bench in
bf16. The port against the JAX package in bf16: ``tests/test_torch_bf16.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from maxsquareloss_torch import bench
from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.kernels.fused_block import FusedBottleneckFn
from maxsquareloss_torch.models import deeplabv2 as tmodel
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train import steps as tsteps
from tests.test_torch_bf16 import (
    BF16,
    BLOCKS,
    HW,
    _one_torch_thread,  # noqa: F401  (the autouse fixture)
    _port_model,
    _port_steps,
    _step_batches,
    jax_weights,  # noqa: F401  (a fixture)
)


# -- remat -------------------------------------------------------------------------


REMAT_CASES = [
    ("float32", "uda", {}), ("bfloat16", "uda", {}),
    ("float32", "supervised", {}), ("bfloat16", "supervised", {}),
    ("float32", "uda", {"concat_batches": True}), ("bfloat16", "uda", {"concat_batches": True}),
]


@pytest.mark.parametrize("dtype,kind,extra", REMAT_CASES,
                         ids=lambda v: "concat" if v == {"concat_batches": True} else str(v or "-"))
def test_remat_step_equals_the_plain_step(jax_weights, dtype, kind, extra):
    """Two steps with ``--remat stages`` and two without, from the same
    weights: the same losses and parameters, bitwise on the CPU."""
    out = {}
    for remat in ("", "stages"):
        cfg = TrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5, compute_dtype=dtype,
                          remat=remat, **extra)
        model = _port_model(*jax_weights, compute_dtype=dtype, remat=remat)
        out[remat] = _port_steps(model, cfg, _step_batches(2), uda=kind == "uda")
    (m0, p0), (m1, p1) = out[""], out["stages"]
    assert m0 == m1
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_forward_equals_the_plain_forward(jax_weights, dtype):
    """The training forward under remat against the plain one, at
    ``tests/test_model.py``'s bound (atol 1e-6), and the gradient it gives."""
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, *HW, 3)).astype(np.float32))
    got = []
    for remat in ("", "stages"):
        model = _port_model(*jax_weights, compute_dtype=dtype, remat=remat)
        aux, main = model(x)
        (aux.sum() + main.sum()).backward()
        got.append((aux.detach(), main.detach(), model.conv1.weight.grad))
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_remat_recomputes_every_identity_block_once():
    """Under remat each identity block's forward runs twice a step (the
    kernel's 58 emit launches a full-R101 step become 116 on the card);
    without, once."""
    calls = {}
    for remat in ("", "stages"):
        cfg = TrainConfig(blocks=BLOCKS, iter_max=100, remat=remat, device="cpu")
        model = tmodel.init_deeplabv2(tsteps.model_config(cfg), 0, device="cpu")
        n = [0]

        def counted(*args, n=n):
            n[0] += 1
            return FusedBottleneckFn.apply(*args)

        model.train_block_fn = counted
        _port_steps(model, cfg, _step_batches(1))
        calls[remat] = n[0]
    forwards = 2 * 4  # source and target, 4 identity blocks at BLOCKS
    assert calls == {"": forwards, "stages": 2 * forwards}


# -- the CLIs and the bench ------------------------------------------------------------


SIZE = ["--base_size", "64,32", "--crop_size", "64,32", "--target_base_size", "64,32",
        "--target_crop_size", "64,32"]
COMMON = ["--device", "cpu", "--blocks", "2,2,2,2", "--batch_size", "2", "--num_workers", "2",
          "--iter_max", "100", "--tqdm", "false", "--show_num_images", "1",
          "--compute_dtype", "bfloat16", "--remat", "stages"]


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """``solve_gta5 --compute_dtype bfloat16 --remat stages`` for 2
    iterations on a small on-disk pair: (datasets root, run dir, trainer)."""
    from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
    from maxsquareloss_torch.tools import solve_gta5

    base = tmp_path_factory.mktemp("bf16_cli")
    data = str(base / "data")
    write_domain_shift_pair(data, n_source=6, n_target_train=6, n_target_val=4, hw=(32, 64))
    run = str(base / "run")
    trainer = solve_gta5.main(["--data_root_path", data, "--checkpoint_dir", run,
                               "--iter_stop", "2", "--threshold", "0.5", *SIZE, *COMMON])
    return data, run, trainer


def _train_losses(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return {r["step"]: r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"}


def test_solve_gta5_bf16_remat_writes_a_fp32_reference_checkpoint(bf16_run):
    _, run, trainer = bf16_run
    assert trainer.state.iteration == 2
    assert (trainer.model.cfg.compute_dtype, trainer.model.cfg.remat) == (BF16, "stages")
    losses = _train_losses(run)
    assert sorted(losses) == [1, 2] and all(np.isfinite(list(losses.values())))
    blob = ckpt_lib.load_checkpoint(os.path.join(run, ckpt_lib.LATEST))
    sd = blob["state_dict"]
    assert {v.dtype for v in sd.values() if v.is_floating_point()} == {torch.float32}
    # the reference's layout: torch BN keys, no folded buffers, no packed copies
    assert "layer1.0.bn1.running_var" in sd and "layer1.0.conv1.weight" in sd
    assert not any(k.endswith((".scale", "_hwio")) for k in sd)
    for k, v in trainer.model.state_dict().items():
        if k in sd:
            assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("tool", ["evaluate", "predict"])
def test_serving_clis_in_bf16_from_the_checkpoint(bf16_run, tmp_path, tool):
    """``evaluate`` and ``predict --compute_dtype bfloat16`` on the bf16
    run's ``.pth``: evaluate gives the in-process model's mIoU, predict one
    trainId PNG pair per val image."""
    from maxsquareloss_torch.tools import evaluate, predict
    from maxsquareloss_torch.train.evaluator import evaluate as evaluate_fn

    data, run, trainer = bf16_run
    argv = ["--dataset", "cityscapes", "--data_root_path", data, "--pretrained_ckpt_file",
            os.path.join(run, ckpt_lib.LATEST), "--checkpoint_dir", str(tmp_path / "ev"),
            "--base_size", "64,32", "--crop_size", "64,32", *COMMON[:-2]]
    if tool == "evaluate":
        out = evaluate.main(argv)
        want = evaluate_fn(trainer.model, trainer.cfg, trainer.val_loader)["MIoU"]
        assert abs(out["MIoU"] - want) <= 1e-6
    else:
        n = predict.main([*argv, "--output_dir", str(tmp_path / "pred")])
        written = sorted(f for f in os.listdir(tmp_path / "pred") if f.endswith(".png"))
        assert n == 4 and len(written) == 2 * n
        assert all(f.endswith(("_trainids.png", "_color.png")) for f in written)


def test_bf16_remat_resume_is_exact(bf16_run, tmp_path):
    """The 2-iteration run resumed with --continue_training to iteration 4
    repeats an uninterrupted 4-iteration run's losses exactly."""
    from maxsquareloss_torch.tools import solve_gta5

    data, run, _ = bf16_run
    resumed = str(tmp_path / "resumed")
    shutil.copytree(run, resumed)
    flags = ["--data_root_path", data, "--iter_stop", "4", "--threshold", "0.5", *SIZE, *COMMON]
    solve_gta5.main([*flags, "--checkpoint_dir", resumed, "--continue_training"])
    whole = str(tmp_path / "whole")
    solve_gta5.main([*flags, "--checkpoint_dir", whole])
    got, want = _train_losses(resumed), _train_losses(whole)
    assert sorted(want) == [1, 2, 3, 4]
    assert all(got[i] == want[i] for i in (1, 2, 3, 4)), (got, want)


TINY = ["--device", "cpu", "--blocks", "2,2,2,2", "--hw", "33,65", "--batch", "2",
        "--steps", "1", "--warmup", "1"]


def test_bench_default_is_the_bf16_line_with_its_fp32_parity_leg(capsys):
    """``--mode uda`` at the defaults: bf16, the fp32 parity leg (fp32,
    stage remat, global batch 8), bf16 inference, and the int8 serving leg
    (``value_infer_int8``) beside it."""
    result = bench.main(["--mode", "uda", *TINY])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    extra = result["extra"]
    assert result["metric"] == "uda_train_images_per_sec_per_chip_65x33_bfloat16"
    assert extra["compute_dtype"] == "bfloat16" and extra["remat"] == ""
    assert extra["value_bf16"] == result["value"] > 0 and "value_fp32" not in extra
    assert extra["fp32_global_batch"] == 8 and extra["value_fp32_parity"] > 0
    assert math.isfinite(extra["fp32_final_loss"]) and extra["fp32_step_ms"] > 0
    assert extra["value_infer_bf16"] > 0 and "value_infer_fp32" not in extra
    assert extra["value_infer_int8"] > 0 and extra["infer_int8_step_ms"] > 0
    assert "infer_int8" not in extra


def test_bench_takes_remat_and_an_fp32_line_has_no_parity_leg(capsys):
    result = bench.main(["--mode", "uda", *TINY, "--remat", "stages", "--dtype", "float32",
                         "--with_infer", "false"])
    extra = result["extra"]
    assert extra["remat"] == "stages" and extra["value_fp32"] == result["value"] > 0
    assert "value_fp32_parity" not in extra and "value_infer_fp32" not in extra
    assert math.isfinite(extra["final_loss"])


def test_e2e_bench_takes_the_dtype(tmp_path):
    from tests.test_torch_bench import _e2e_args
    from maxsquareloss_torch.experiments import bench_e2e

    result = bench_e2e.run_e2e(_e2e_args(tmp_path, dtype="bfloat16", remat="stages"))
    assert result["metric"].endswith("_bfloat16")
    extra = result["extra"]
    assert (extra["compute_dtype"], extra["remat"]) == ("bfloat16", "stages")
    assert result["value"] > 0 and math.isfinite(extra["final_loss"])


def test_config_dtype_property():
    assert TrainConfig().dtype == torch.float32
    assert TrainConfig(compute_dtype="bfloat16").dtype == BF16
    mcfg = tsteps.model_config(dataclasses.replace(TrainConfig(), compute_dtype="bfloat16",
                                                   remat="stages"))
    assert (mcfg.compute_dtype, mcfg.remat) == (BF16, "stages")
