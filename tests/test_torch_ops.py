"""The port's resize, confusion matrix, Eval metrics, input normalization
and ceil-mode pool against the JAX package on the same numpy inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxsquareloss_tpu import metrics as jmetrics
from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
from maxsquareloss_tpu.models.layers import max_pool_ceil as jmax_pool_ceil
from maxsquareloss_tpu.ops import resize as jresize
from maxsquareloss_tpu.train.steps import _prepare_inputs as jprepare
from maxsquareloss_torch import metrics as tmetrics
from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.models.layers import max_pool_ceil
from maxsquareloss_torch.ops import resize as tresize
from maxsquareloss_torch.train.steps import _prepare_inputs


@pytest.mark.parametrize(
    "in_hw,out_hw,h_rows",
    [
        ((9, 17), (33, 65), None),      # upsample, logits-like
        ((33, 65), (9, 17), None),      # downsample (TTA scale < 1)
        ((9, 17), (64, 128), (16, 40)), # a row block of the full result
        ((9, 17), (64, 128), (60, 64)), # the ragged last block
        ((1, 7), (5, 1), None),         # in_size 1 and out_size 1
        ((6, 1), (1, 4), None),
    ],
)
def test_resize_matches_jax(in_hw, out_hw, h_rows):
    x = np.random.default_rng(1).normal(size=(2, *in_hw, 5)).astype(np.float32)
    want = jresize.resize_bilinear_align_corners(jnp.asarray(x), out_hw, h_rows=h_rows)
    got = tresize.resize_bilinear_align_corners(torch.from_numpy(x), out_hw, h_rows=h_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_interp_matrix_identical():
    for out_size, in_size in ((65, 9), (1, 5), (5, 1), (512, 129)):
        np.testing.assert_array_equal(
            tresize._interp_matrix_np(out_size, in_size),
            jresize._interp_matrix_np(out_size, in_size),
        )


def _cm_inputs(seed=2, c=19):
    rng = np.random.default_rng(seed)
    gt = rng.integers(-1, c, size=(3, 17, 23)).astype(np.int32)  # -1 = ignore
    pred = rng.integers(0, c, size=(3, 17, 23)).astype(np.int32)
    return gt, pred


def test_confusion_matrix_exactly_equal():
    gt, pred = _cm_inputs()
    want = np.asarray(jmetrics.confusion_matrix_update(jnp.asarray(gt), jnp.asarray(pred), 19))
    got = tmetrics.confusion_matrix_update(torch.from_numpy(gt), torch.from_numpy(pred), 19)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.sum().item() == int((gt >= 0).sum())


def test_eval_metrics_identical():
    jev, tev = jmetrics.Eval(19), tmetrics.Eval(19)
    for seed in (3, 4):
        gt, pred = _cm_inputs(seed)
        pred[pred == 4] = 5  # an empty prediction column → nan handling
        jev.add_confusion_matrix(np.asarray(
            jmetrics.confusion_matrix_update(jnp.asarray(gt), jnp.asarray(pred), 19)))
        tev.add_confusion_matrix(tmetrics.confusion_matrix_update(
            torch.from_numpy(gt), torch.from_numpy(pred), 19))
    np.testing.assert_array_equal(tev.confusion_matrix, jev.confusion_matrix)
    for name in ("Pixel_Accuracy", "Mean_Pixel_Accuracy", "Mean_Intersection_over_Union",
                 "Mean_Intersection_over_Union_16", "Mean_Intersection_over_Union_13",
                 "Frequency_Weighted_Intersection_over_Union", "Mean_Precision"):
        assert getattr(tev, name)() == getattr(jev, name)(), name
    assert tev.Print_Every_class_Eval() == jev.Print_Every_class_Eval()
    assert tmetrics.SYNTHIA_SET_16 == jmetrics.SYNTHIA_SET_16
    assert tmetrics.SYNTHIA_SET_13 == jmetrics.SYNTHIA_SET_13


@pytest.mark.parametrize("numpy_transform", [True, False])
def test_prepare_inputs_matches_jax(numpy_transform):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, size=(2, 7, 9, 3)).astype(np.uint8)
    y = rng.integers(-1, 19, size=(2, 7, 9)).astype(np.int8)
    jx, jy = jprepare(jnp.asarray(x), jnp.asarray(y), JTrainConfig(numpy_transform=numpy_transform))
    tx, ty = _prepare_inputs(torch.from_numpy(x), torch.from_numpy(y),
                             TrainConfig(numpy_transform=numpy_transform))
    assert tx.dtype == torch.float32 and ty.dtype == torch.int64
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    if numpy_transform:  # caffe path: uint8→f32 and one subtraction, bitwise
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    else:  # torchvision path: a divide chain, within 2 ulp
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=3e-7, atol=3e-7)


@pytest.mark.parametrize("hw", [(129, 257), (65, 129), (8, 9)])
def test_ceil_pool_matches_jax(hw):
    x = np.random.default_rng(6).normal(size=(2, *hw, 4)).astype(np.float32)
    want = np.asarray(jmax_pool_ceil(jnp.asarray(x), window=3, stride=2, padding=1))
    got = max_pool_ceil()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
