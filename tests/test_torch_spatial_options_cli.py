"""``solve_gta5 --sp 2`` with ``--concat_batches true`` (unequal source
and target crops: the masked canvas on row shards) and with ``--remat
stages``, each as two gloo processes (``torchrun``), against the same CLI
in one process on the same ``.pth`` and data: 2 iterations of global batch
2, a validation and a checkpoint. The two launches start together; the
one-process runs go meanwhile in this process. Tolerances as
``tests/test_torch_spatial_cli.py``'s ``solve_gta5 --sp 2``: losses rtol
1e-5, validation metrics 1e-4, parameter changes 1e-4 relative L2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maxsquareloss_torch.convert import reference_state_dict
from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2Config, init_deeplabv2
from maxsquareloss_torch.train import checkpoint as ckpt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = "2,2,2,2"
RUNS = {
    "concat": ["--concat_batches", "true", "--target_base_size", "48,24",
               "--target_crop_size", "48,24"],
    "remat": ["--remat", "stages", "--target_base_size", "64,32", "--target_crop_size", "64,32"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (the torchrun run's directory, the one-process trainer, its
    directory)} and the starting parameters."""
    from maxsquareloss_torch.tools import solve_gta5

    base = tmp_path_factory.mktemp("sp_options_cli")
    data = str(base / "data")
    write_domain_shift_pair(data, n_source=4, n_target_train=4, n_target_val=3, hw=(32, 64))
    start = init_deeplabv2(DeepLabV2Config(blocks=tuple(int(b) for b in BLOCKS.split(","))),
                           torch.Generator().manual_seed(0), device="cpu")
    torch.save({"state_dict": reference_state_dict(start)}, base / "init.pth")
    common = ["--data_root_path", data, "--device", "cpu", "--blocks", BLOCKS,
              "--batch_size", "2", "--num_workers", "1", "--iter_max", "100",
              "--iter_stop", "2", "--tqdm", "false", "--iw_hist", "argmax",
              "--pretrained_ckpt_file", str(base / "init.pth"), "--base_size", "64,32",
              "--crop_size", "64,32"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "maxsquareloss_torch.tools.solve_gta5", *common, *flags, "--sp", "2",
         "--checkpoint_dir", str(base / f"sp2_{name}")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in RUNS.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, flags in RUNS.items():
            one_dir = str(base / f"one_{name}")
            out[name] = [str(base / f"sp2_{name}"),
                         solve_gta5.main([*common, *flags, "--checkpoint_dir", one_dir]), one_dir]
        for name, proc in procs.items():
            text = proc.communicate(timeout=300)[0]
            assert proc.returncode == 0, text[-6000:]
    finally:
        torch.set_num_threads(threads)
        for proc in procs.values():
            proc.kill()
    return out, dict(start.named_parameters())


def _scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", list(RUNS))
def test_solve_gta5_sp2_option_matches_one_process(runs, name):
    (sp_dir, one, one_dir), start = runs[0][name], runs[1]
    assert one.cfg.concat_batches == (name == "concat")
    assert one.cfg.remat == ("stages" if name == "remat" else "")
    sp_s, one_s = _scalars(sp_dir), _scalars(one_dir)
    assert [(r["tag"], r["step"]) for r in sp_s] == [(r["tag"], r["step"]) for r in one_s]
    assert {"train/loss", "val/MIoU"} <= {r["tag"] for r in sp_s}
    for a, b in zip(sp_s, one_s):
        if a["tag"].startswith("train/") and a["tag"] != "train/images_per_sec":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-5, atol=1e-7,
                                       err_msg=a["tag"])
        elif a["tag"].startswith("val/"):
            assert abs(a["value"] - b["value"]) <= 1e-4, (a["tag"], a["value"], b["value"])
    sp2 = ckpt_lib.load_checkpoint(os.path.join(sp_dir, ckpt_lib.LATEST))
    assert sp2["iteration"] == 2
    one_params = {n: p.detach().clone() for n, p in one.model.named_parameters()}
    ckpt_lib.load_weights(one.model, sp2, 19)
    worst = 0.0
    for n, p in one.model.named_parameters():
        change = one_params[n].double() - start[n].detach().double()
        err = float(((p.detach().double() - start[n].detach().double()) - change).norm()
                    / change.norm())
        worst = max(worst, err)
    assert worst <= 1e-4, f"a parameter's change is off by {worst:.3g} (relative L2)"
