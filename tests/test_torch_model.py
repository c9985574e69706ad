"""The port's DeepLabV2 against ``apply_deeplabv2`` with the same random JAX
weights carried across. ``blocks=(2,2,3,2)`` gives every layer an identity
block (the fused-kernel path); BN biases are randomized so the folded
affine is exercised. Tolerance atol = rtol = 1e-4 (the README's oracle
bound: fp32 through ~30 convs in another summation order, and the JAX side
sums the ASPP head in a different order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxsquareloss_tpu.convert import pytrees_to_torch_state_dict
from maxsquareloss_tpu.models import deeplabv2 as jmodel
from maxsquareloss_torch.convert import load_reference_state_dict, state_dict_from_jax
from maxsquareloss_torch.models import deeplabv2 as tmodel

BLOCKS = (2, 2, 3, 2)
HW = (65, 129)


@pytest.fixture(scope="module")
def weights():
    cfg = jmodel.DeepLabV2Config(num_classes=19, multi_level=True, blocks=BLOCKS)
    params, frozen = jmodel.init_deeplabv2(jax.random.key(0), cfg)
    rng = np.random.default_rng(11)
    params = jax.tree.map(np.asarray, params)
    frozen = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, size=v.shape).astype(np.float32),
        frozen,
    )
    x = np.random.default_rng(12).normal(0, 50, size=(1, *HW, 3)).astype(np.float32)
    aux, main = jmodel.apply_deeplabv2(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, frozen),
        jnp.asarray(x), cfg,
    )
    return params, frozen, x, np.asarray(aux), np.asarray(main)


def _port_model():
    cfg = tmodel.DeepLabV2Config(num_classes=19, multi_level=True, blocks=BLOCKS)
    return tmodel.DeepLabV2(cfg).to(memory_format=torch.channels_last).eval()


def _check(model, x, aux_want, main_want):
    with torch.inference_mode():
        aux, main = model(torch.from_numpy(x))
    assert main.shape == main_want.shape and aux.shape == aux_want.shape
    assert main.shape[1:3] == tmodel.valid_logits_hw(HW)
    np.testing.assert_allclose(main.numpy(), main_want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux.numpy(), aux_want, rtol=1e-4, atol=1e-4)


def test_logits_match_jax(weights):
    params, frozen, x, aux, main = weights
    model = _port_model()
    model.load_state_dict(state_dict_from_jax(params, frozen))
    assert sum(b.fusable for layer in (model.layer1, model.layer2, model.layer3,
                                       model.layer4) for b in layer) == 5
    _check(model, x, aux, main)


def test_reference_state_dict_loads_to_same_logits(weights):
    params, frozen, x, aux, main = weights
    model = _port_model()
    load_reference_state_dict(
        model, pytrees_to_torch_state_dict(params, frozen, module_prefix=True)
    )
    _check(model, x, aux, main)


@pytest.mark.parametrize("hw", [(65, 129), (512, 1024), (384, 768), (33, 64), (1, 1)])
def test_valid_logits_hw_matches_jax(hw):
    assert tmodel.valid_logits_hw(hw) == jmodel.valid_logits_hw(hw)


@pytest.mark.parametrize("source", ["load", "init"])
def test_kernel_weights_follow_the_convs(weights, source):
    """The identity blocks' HWIO kernel weights are rebuilt on load and by
    init, stay contiguous after a channels_last move, and are not saved."""
    if source == "load":
        params, frozen = weights[:2]
        model = tmodel.DeepLabV2(tmodel.DeepLabV2Config(blocks=BLOCKS))
        model.load_state_dict(state_dict_from_jax(params, frozen))
        model = model.to(memory_format=torch.channels_last)
    else:
        model = tmodel.init_deeplabv2(tmodel.DeepLabV2Config(blocks=BLOCKS),
                                      torch.Generator().manual_seed(0), device="cpu")
    blocks = [b for layer in (model.layer1, model.layer2, model.layer3, model.layer4)
              for b in layer if b.fusable]
    assert len(blocks) == 5
    for b in blocks:
        for i in (1, 2, 3):
            w = b._hwio(i)
            assert w.is_contiguous()
            torch.testing.assert_close(
                w, getattr(b, f"conv{i}").weight.permute(2, 3, 1, 0), rtol=0, atol=0
            )
    assert not any("hwio" in k for k in model.state_dict())


def test_frozen_bn_is_buffers():
    model = _port_model()
    names = {n for n, _ in model.named_parameters()}
    assert not any(".bn" in n or n.startswith("bn") or "downsample.1" in n for n in names)
    assert "layer1.0.bn1.scale" in dict(model.named_buffers())
