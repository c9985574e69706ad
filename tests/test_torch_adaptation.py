"""The adaptation-efficacy gate over the port's CLIs (the port of
``tests/test_adaptation.py``).

The slow gate runs the JAX gate's protocol on the CPU through
``experiments/adaptation_efficacy.run_seed``: seed 0, the synthetic
domain-shift pair, 300 source iterations, then the ``lambda_target 0``
control and ``IW_maxsquare`` at lambda 64 for 200 iterations each
(``--blocks 1,1,2,1``, 128x64, batch 8). UDA must beat both the control and
the source-only checkpoint on target-val mIoU by more than 0.03, the JAX
gate's margins. The fast test runs the same harness for 2 iterations each
and checks that every arm reports a finite mIoU.

The margins were set on the JAX package's seed-0 run, so the port's trainer
starts from the JAX package's initial weights for its ``--seed``
(``init_deeplabv2(cfg, seed)``): from another draw of the same distribution
the port's seed 0 adapted by 0.0295, under the margin. The fast tests hold
those draws against ``jax.random``.
"""

from __future__ import annotations

import math

import pytest
import torch

from maxsquareloss_torch.experiments import adaptation_efficacy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    argv = ["--seeds", "0", "--modes", "IW_maxsquare@64", "--device", "cpu"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return adaptation_efficacy.parse_args(argv)


@pytest.mark.parametrize("seed", [0, 7])
def test_jax_random_keys_and_normals(seed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from maxsquareloss_torch.utils import jax_random

    k = jax.random.key(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(k)), np.array(jax_random.key(seed)))
    keys = jax.random.split(k, 256)
    mine = jax_random.split(jax_random.key(seed), 256)
    assert np.array_equal(np.asarray(jax.random.key_data(keys)), np.array(mine))
    want = np.asarray(jax.random.normal(keys[9], (3, 3, 64, 96), jnp.float32))
    got = jax_random.normal(mine[9], (3, 3, 64, 96)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4 and (ulps == 0).mean() >= 0.98


@pytest.mark.parametrize("multi", [True, False], ids=["multi", "single"])
def test_trainer_starts_from_the_jax_init(tmp_path, multi):
    """The trainer's model for --seed s is the JAX package's init for key(s)."""
    import jax
    import numpy as np

    from maxsquareloss_torch.config import TrainConfig
    from maxsquareloss_torch.convert import state_dict_from_jax
    from maxsquareloss_torch.train.trainer import Trainer
    from maxsquareloss_tpu.models import deeplabv2 as jmodel

    blocks = (1, 1, 2, 1)
    params, frozen = jmodel.init_deeplabv2(
        jax.random.key(3), jmodel.DeepLabV2Config(multi_level=multi, blocks=blocks))
    want = state_dict_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, frozen))
    cfg = TrainConfig(blocks=blocks, multi=multi, seed=3, device="cpu",
                      checkpoint_dir=str(tmp_path))
    got = Trainer(cfg, [], None).model.state_dict()
    assert set(want) <= set(got)
    same = total = 0
    for k, v in want.items():
        v = torch.as_tensor(v)
        assert torch.allclose(got[k], v, rtol=1e-6, atol=0), k
        same += int((got[k] == v).sum())
        total += v.numel()
    assert same >= 0.98 * total


def test_multi_level_checkpoint_loads_into_a_single_head_model():
    """The UDA arms adapt with --multi false from a multi-level source
    checkpoint: the aux head the model lacks is dropped, the rest loads."""
    from maxsquareloss_torch.models.deeplabv2 import DeepLabV2, DeepLabV2Config
    from maxsquareloss_torch.convert import reference_state_dict
    from maxsquareloss_torch.train.checkpoint import load_weights

    blocks = (1, 1, 2, 1)
    src = DeepLabV2(DeepLabV2Config(blocks=blocks, multi_level=True))
    dst = DeepLabV2(DeepLabV2Config(blocks=blocks, multi_level=False))
    assert load_weights(dst, reference_state_dict(src), 19) == []
    want = src.state_dict()
    for k, v in dst.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_run_seed_reports_every_arm(tmp_path):
    res = adaptation_efficacy.run_seed(str(tmp_path), 0, _args(
        iters_src=2, iters_uda=2, n_images=8, n_val=2))
    assert set(res) == {"in_domain", "source_only", "control_l0", "IW_maxsquare@64", "_wall_s"}
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for k, v in res.items() if k != "_wall_s")


@pytest.mark.slow
def test_uda_beats_source_only_on_domain_shift(tmp_path):
    res = adaptation_efficacy.run_seed(str(tmp_path), 0, _args())
    miou_src, miou_ctrl, miou_uda = res["source_only"], res["control_l0"], res["IW_maxsquare@64"]
    assert miou_uda > miou_ctrl + 0.03, (
        f"UDA does not beat the lambda_target=0 control: "
        f"{miou_uda:.4f} vs {miou_ctrl:.4f} (source-only {miou_src:.4f})")
    assert miou_uda > miou_src + 0.03, (
        f"UDA does not beat the source-only checkpoint: {miou_uda:.4f} vs {miou_src:.4f}")
