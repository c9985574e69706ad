"""The port's losses, histogram, SGD and poly LR against the JAX package,
on the cases of ``tests/test_losses.py`` and ``tests/test_optim.py``, from
seeded numpy inputs. Tolerances: loss values rtol 1e-5 against the same
formula in float64, and rtol 2e-5 against the JAX function (XLA's CPU
reduction of the ~15k fp32 terms of these cases is itself off a float64
sum by up to 1.6e-5 relative); gradients (with respect to the logits,
through the softmax; ``jax.grad`` on the JAX side) atol 1e-6; histograms
and pseudo-labels exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxsquareloss_tpu import optim as joptim
from maxsquareloss_tpu.models import deeplabv2 as jmodel
from maxsquareloss_tpu.ops import histogram as jhist
from maxsquareloss_tpu.ops import losses as jlosses
from maxsquareloss_torch import optim as toptim
from maxsquareloss_torch.models import deeplabv2 as tmodel
from maxsquareloss_torch.ops import histogram as thist
from maxsquareloss_torch.ops import losses as tlosses

C = 19


def _logits(seed, n=2, h=17, w=23, sharp=3.0):
    return np.random.default_rng(seed).standard_normal((n, h, w, C), dtype=np.float32) * sharp


def _labels(seed, shape):
    return np.random.default_rng(seed).integers(-1, C, size=shape).astype(np.int32)


def test_class_histogram_exact():
    labels = _labels(1, (3, 17, 23))
    got = thist.class_histogram(torch.from_numpy(labels), C)
    assert got.dtype == torch.float32 and got.shape == (3, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhist.class_histogram(jnp.asarray(labels), C)))


@pytest.mark.parametrize("case", ["random", "clamp_at_one", "empty_class"])
def test_iw_class_weights_match_jax(case):
    if case == "random":
        labels = _labels(2, (2, 17, 23))
    elif case == "clamp_at_one":  # one pixel of class 0, the rest ignored
        labels = np.full((1, 1, 2), -1, np.int32)
        labels[0, 0, 0] = 0
    else:  # all-ignored image beside a full one: hist 0 → weight 1.0
        labels = _labels(3, (2, 9, 11))
        labels[1] = -1
    want = jhist.iw_class_weights(jhist.class_histogram(jnp.asarray(labels), C), 0.2)
    got = thist.iw_class_weights(thist.class_histogram(torch.from_numpy(labels), C), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def _check_value_and_grad(jfn, tfn, logits, *args):
    """jfn/tfn: logits (+ args) → scalar loss; the value against tfn in
    float64 (rtol 1e-5) and against jfn (rtol 2e-5), the grad against
    jax.grad (atol 1e-6)."""
    jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits), *args)
    x = torch.from_numpy(logits.copy()).requires_grad_(True)
    targs = [torch.from_numpy(np.array(a)) if isinstance(a, (np.ndarray, jax.Array)) else a
             for a in args]
    val = tfn(x, *targs)
    val.backward()
    assert val.dtype == torch.float32 and val.dim() == 0
    f64 = tfn(x.detach().double(), *(a.double() if isinstance(a, torch.Tensor)
                                     and a.is_floating_point() else a for a in targs))
    np.testing.assert_allclose(val.item(), f64.item(), rtol=1e-5)
    np.testing.assert_allclose(val.item(), float(jval), rtol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=1e-6)


def test_cross_entropy_matches_jax():
    logits = _logits(4, 2, 9, 11, sharp=1.0)
    labels = _labels(5, (2, 9, 11))
    _check_value_and_grad(jlosses.cross_entropy, tlosses.cross_entropy, logits, labels)


def test_cross_entropy_all_ignored_is_zero():
    """torch's CE reads NaN here; the JAX package (and the port) 0."""
    logits = _logits(6, 1, 2, 2, sharp=1.0)
    labels = np.full((1, 2, 2), -1, np.int32)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = tlosses.cross_entropy(x, torch.from_numpy(labels))
    loss.backward()
    assert loss.item() == 0.0 == float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert torch.count_nonzero(x.grad) == 0


def test_soft_cross_entropy_matches_jax():
    logits = _logits(7, 1, 5, 7, sharp=1.0)
    q = np.asarray(jax.nn.softmax(jnp.asarray(_logits(8, 1, 5, 7, sharp=1.0)), axis=-1))
    _check_value_and_grad(jlosses.soft_cross_entropy, tlosses.soft_cross_entropy, logits, q)


def _via_softmax(fn, jax_side):
    if jax_side:
        return lambda x, *a, **k: fn(jax.nn.softmax(x, axis=-1), *a, **k)
    return lambda x, *a, **k: fn(torch.softmax(x, dim=-1), *a, **k)


@pytest.mark.parametrize("name", ["max_square_loss", "entropy_loss"])
def test_probability_losses_match_jax(name):
    _check_value_and_grad(_via_softmax(getattr(jlosses, name), True),
                          _via_softmax(getattr(tlosses, name), False), _logits(9))


@pytest.mark.parametrize("name", ["iw_max_square_loss", "iw_entropy_loss"])
@pytest.mark.parametrize("with_label", [False, True])
def test_iw_losses_match_jax(name, with_label):
    logits = _logits(10)
    label = _labels(11, logits.shape[:3]) if with_label else None
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)

    def jloss(x):
        return jfn(jax.nn.softmax(x, axis=-1), None if label is None else jnp.asarray(label),
                   num_classes=C)

    def tloss(x):
        return tfn(torch.softmax(x, dim=-1), None if label is None else torch.from_numpy(label),
                   num_classes=C)

    _check_value_and_grad(jloss, tloss, logits)


@pytest.mark.parametrize("mask_mode", ["ensemble", "per_head_or"])
def test_self_produced_guidance_exact(mask_mode):
    pm = np.array(jax.nn.softmax(jnp.asarray(_logits(12, sharp=6.0)), axis=-1))
    pa = np.array(jax.nn.softmax(jnp.asarray(_logits(13, sharp=6.0)), axis=-1))
    want = jlosses.self_produced_guidance(jnp.asarray(pm), jnp.asarray(pa), 0.8, mask_mode=mask_mode)
    got = tlosses.self_produced_guidance(torch.from_numpy(pm), torch.from_numpy(pa), 0.8,
                                         mask_mode=mask_mode)
    assert got.dtype == torch.int64
    assert 0 < int((got != -1).sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("iteration", [0, 7, 99, 100, 1000])
def test_poly_lr_matches_jax(iteration):
    """Past iter_max both clamp the base at 0 (a bare reference formula
    would raise a negative base to the power 0.9)."""
    want = float(joptim.poly_lr(2.5e-4, jnp.asarray(iteration), 100, 0.9))
    got = toptim.poly_lr(2.5e-4, iteration, 100, 0.9)
    assert got == pytest.approx(want, rel=1e-6, abs=0.0)
    if iteration >= 100:
        assert got == 0.0


def test_param_groups_follow_lr_mult_tree():
    """layer5/layer6 at 10x, everything else (biases included) at 1x, as
    lr_mult_tree; the two groups hold every parameter once."""
    blocks = (1, 1, 1, 1)
    model = tmodel.DeepLabV2(tmodel.DeepLabV2Config(blocks=blocks))
    groups = tmodel.param_groups(model)
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0]
    names = {id(p): n for n, p in model.named_parameters()}
    assert sorted(id(p) for g in groups for p in g["params"]) == sorted(names)
    params, _ = jmodel.init_deeplabv2(jax.random.key(0), jmodel.DeepLabV2Config(blocks=blocks))
    jmults = {k: set(jax.tree.leaves(v)) for k, v in jmodel.lr_mult_tree(params).items()}
    for g in groups:
        for p in g["params"]:
            assert jmults[names[id(p)].split(".")[0]] == {g["lr_mult"]}


def test_sgd_matches_jax_sgd_update():
    """make_sgd + set_lr over 5 steps against sgd_update: coupled weight
    decay, first-step momentum seed, two groups; atol 1e-6."""
    rng = np.random.default_rng(14)

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer1 = torch.nn.Linear(3, 4)
            self.layer6 = torch.nn.Linear(4, 2)

    model = Two()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32)))
    names = [n for n, _ in model.named_parameters()]
    # copies: jnp.asarray may alias the numpy view of a tensor that the
    # torch step then updates in place
    params = {n: jnp.asarray(p.detach().numpy().copy()) for n, p in model.named_parameters()}
    mults = {n: 10.0 if n.startswith("layer6") else 1.0 for n in names}
    state = joptim.init_sgd(params)

    class Cfg:
        lr, momentum, weight_decay = 0.1, 0.9, 5e-4

    opt = toptim.make_sgd(model, Cfg)
    for it in range(5):
        grads = {n: rng.standard_normal(params[n].shape, dtype=np.float32) for n in names}
        lr = toptim.poly_lr(0.1, it, 10, 0.9)
        toptim.set_lr(opt, lr)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        params, state = joptim.sgd_update(
            params, {n: jnp.asarray(g) for n, g in grads.items()}, state,
            joptim.poly_lr(0.1, jnp.asarray(it), 10, 0.9), mults,
            momentum=0.9, weight_decay=5e-4,
        )
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), atol=1e-6, rtol=0)
