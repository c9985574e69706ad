"""The port's checkpoints (``train/checkpoint.py``): a round trip of the
model, the SGD momentum buffers (keyed by parameter name), the iteration,
epoch, best mIoU and batch offset, exact enough that the next step is
bitwise the same; a reference-layout ``.pth`` written from JAX parameters by
the JAX package's own ``pytrees_to_torch_state_dict`` (as
``tools/export_torch_ckpt.py`` writes it) loads into the port, whose logits
then match the JAX forward at rtol 1e-5; ``module.``-prefixed files and a
class-count change behave as ``tests/test_checkpoint.py`` pins for JAX.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.convert import reference_state_dict, unfold_bn_exact
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2, DeepLabV2Config, init_deeplabv2
from maxsquareloss_torch.models.layers import fold_bn
from maxsquareloss_torch.tools.common import load_inference_model
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train import steps as tsteps
from maxsquareloss_tpu.convert import pytrees_to_torch_state_dict
from maxsquareloss_tpu.models import deeplabv2 as jmodel

BLOCKS = (2, 2, 2, 2)
HW = (33, 65)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed, num_classes=19):
    cfg = DeepLabV2Config(num_classes=num_classes, blocks=BLOCKS)
    model = init_deeplabv2(cfg, torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():  # BN away from the identity, so it is tested too
        g = torch.Generator().manual_seed(seed + 100)
        for name, buf in model.named_buffers():
            if name.endswith((".scale", ".bias")) and buf is not None:
                buf.add_(torch.randn(buf.shape, generator=g) * 0.05)
    model.pack_weights()
    return model


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(0, 1, (2, *HW, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(-1, 19, (2, *HW)).astype(np.int32)),
            torch.from_numpy(rng.normal(0, 1, (2, *HW, 3)).astype(np.float32)))


def test_round_trip_resumes_bitwise(tmp_path):
    """Save after one UDA step; a different model and a fresh optimizer
    loaded from the file take the same second step as the original."""
    cfg = TrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5)
    step = tsteps.make_uda_train_step(cfg)
    model = _model(0)
    state = tsteps.make_train_state(model, cfg)
    state, _ = step(state, *_batch(0))
    path = ckpt_lib.save_checkpoint(str(tmp_path), model, state.optimizer, state.iteration,
                                    epoch=2, best_miou=0.25, is_best=True, epoch_batch=5)
    blob = ckpt_lib.load_checkpoint(path)
    assert set(blob) == {"epoch", "iteration", "state_dict", "optimizer", "best_MIou",
                         "epoch_batch"}
    assert (blob["epoch"], blob["iteration"], blob["best_MIou"], blob["epoch_batch"]) == (
        2, 1, 0.25, 5)
    assert (tmp_path / ckpt_lib.BEST).exists()
    # momentum buffers keyed by parameter name
    names = dict(model.named_parameters())
    assert set(blob["optimizer"]["state"]) == set(names)
    for name, s in blob["optimizer"]["state"].items():
        assert torch.equal(s["momentum_buffer"], state.optimizer.state[names[name]]["momentum_buffer"])

    other = _model(7)
    assert ckpt_lib.load_weights(other, blob, 19) == []
    for k, v in other.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    state2 = tsteps.make_train_state(other, cfg)
    ckpt_lib.restore_optimizer_state(other, state2.optimizer, blob["optimizer"])
    state2.iteration = blob["iteration"]
    state, m1 = step(state, *_batch(1))
    state2, m2 = step(state2, *_batch(1))
    assert {k: v.item() for k, v in m1.items()} == {k: v.item() for k, v in m2.items()}
    for (n1, p1), (n2, p2) in zip(model.named_parameters(), other.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1


def test_reference_state_dict_keys_and_exact_bn(tmp_path):
    model = _model(3)
    sd = reference_state_dict(model)
    assert "bn1.running_var" in sd and "layer1.0.downsample.1.running_mean" in sd
    assert "layer6.conv2d_list.3.bias" in sd and not any(k.endswith(".scale") for k in sd)
    rng = np.random.default_rng(0)
    for lo, hi in ((1e-4, 1e-2), (0.05, 3.0)):
        scale = np.exp(rng.uniform(np.log(lo), np.log(hi), 200_000)).astype(np.float32)
        bn = unfold_bn_exact(scale, scale)
        back, bias = fold_bn(bn["weight"], bn["bias"], bn["running_mean"], bn["running_var"])
        assert np.array_equal(back, scale) and np.array_equal(bias, scale)


def _jax_weights(num_classes=19):
    cfg = jmodel.DeepLabV2Config(num_classes=num_classes, multi_level=True, blocks=BLOCKS)
    params, frozen = jmodel.init_deeplabv2(jax.random.key(4), cfg)
    rng = np.random.default_rng(5)
    frozen = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, size=v.shape).astype(np.float32), frozen)
    return cfg, jax.tree.map(np.asarray, params), frozen


@pytest.mark.parametrize("layout", ["bare", "full_module_prefix"])
def test_pth_from_jax_params_matches_jax_forward(tmp_path, layout):
    jcfg, params, frozen = _jax_weights()
    sd = pytrees_to_torch_state_dict(params, frozen, module_prefix=layout != "bare")
    sd_t = {k: torch.from_numpy(v.copy()) if hasattr(v, "ndim") and v.ndim else torch.tensor(v)
            for k, v in sd.items()}
    blob = sd_t if layout == "bare" else {"epoch": 3, "iteration": 99, "state_dict": sd_t}
    path = str(tmp_path / "ref.pth")
    torch.save(blob, path)

    model = _model(11)
    ckpt_lib.load_torch_pth(path, model, 19)
    x = np.random.default_rng(6).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    aux_j, main_j = jax.jit(lambda p, f, xx: jmodel.apply_deeplabv2(p, f, xx, jcfg))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, frozen), jnp.asarray(x))
    with torch.inference_mode():  # the eval kernel path: the repacked weights
        aux_t, main_t = model(torch.from_numpy(x))
    scale = np.abs(np.asarray(main_j)).max()
    np.testing.assert_allclose(main_t.numpy(), np.asarray(main_j), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(aux_t.numpy(), np.asarray(aux_j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(aux_j)).max())


def test_head_count_mismatch_keeps_fresh_heads(tmp_path):
    """A 19-class file into a 13-class model: the trunk loads, the heads
    keep their init (the reference re-inits its classifiers)."""
    src = _model(1, num_classes=19)
    path = str(tmp_path / "ref19.pth")
    torch.save(reference_state_dict(src), path)
    dst = _model(2, num_classes=13)
    heads0 = {k: v.clone() for k, v in dst.state_dict().items() if k.startswith(("layer5", "layer6"))}
    missing = ckpt_lib.load_torch_pth(path, dst, num_classes=13)
    assert missing and all(k.startswith(("layer5.", "layer6.")) for k in missing)
    for k, v in dst.state_dict().items():
        if k in heads0:
            assert torch.equal(v, heads0[k])
        else:
            assert torch.equal(v, src.state_dict()[k]), k


def test_wrong_depth_raises(tmp_path):
    cfg = DeepLabV2Config(blocks=(1, 1, 2, 1))
    other = DeepLabV2(cfg)
    with pytest.raises(ValueError, match="does not fit"):
        ckpt_lib.load_weights(_model(0), reference_state_dict(other), 19)


def test_load_inference_model(tmp_path):
    src = _model(5)
    path = str(tmp_path / "m.pth")
    torch.save({"state_dict": reference_state_dict(src)}, path)
    cfg = TrainConfig(blocks=BLOCKS, pretrained_ckpt_file=path)
    model = load_inference_model(cfg, torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k


def test_training_checkpoint_detection(tmp_path):
    model = _model(0)
    opt = tsteps.make_train_state(model, TrainConfig(blocks=BLOCKS)).optimizer
    path = ckpt_lib.save_checkpoint(str(tmp_path), model, opt, 4, 1, 0.0)
    assert ckpt_lib.is_training_checkpoint(ckpt_lib.load_checkpoint(path))
    assert not ckpt_lib.is_training_checkpoint(reference_state_dict(model))
    reference_full = {"epoch": 1, "iteration": 4, "state_dict": {},
                      "optimizer": {"state": {0: {}}, "param_groups": []}}
    assert not ckpt_lib.is_training_checkpoint(reference_full)
