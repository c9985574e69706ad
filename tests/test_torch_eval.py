"""The slice as a whole: the port's eval step and predict function against
the JAX package's ``make_multiscale_eval_step`` and
``tools/predict.make_predict_fn`` on the same uint8 batch, labels and
weights.

The two sides differ in summation order only (the JAX eval graph sums the
ASPP head through its matmul rewrite), so a pixel whose top two scores are
closer than 1e-3 may flip. What must agree: the argmax wherever that gap
exceeds 1e-3, the confusion matrix restricted to those pixels exactly, and
mIoU within 1e-3.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
from maxsquareloss_tpu.metrics import Eval as JEval
from maxsquareloss_tpu.models.deeplabv2 import init_deeplabv2 as jinit
from maxsquareloss_tpu.train.evaluator import make_multiscale_eval_step as jmake_step
from maxsquareloss_tpu.train.steps import _prepare_inputs as jprepare
from maxsquareloss_tpu.train.steps import model_config as jmodel_config
from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.convert import state_dict_from_jax
from maxsquareloss_torch.metrics import Eval
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2
from maxsquareloss_torch.predict import make_predict_fn
from maxsquareloss_torch.train.evaluator import tta_prob_rows
from maxsquareloss_torch.train.steps import _prepare_inputs, make_eval_step, model_config
from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step
from tools.predict import make_predict_fn as jmake_predict_fn

BLOCKS = (2, 2, 2, 2)
IMG_HW = (33, 65)
GAP = 1e-3

# (scales, flip, h_chunk, label size)
CASES = {
    "single_scale": ((1.0,), False, 0, IMG_HW),
    "h_chunk": ((1.0,), False, 16, (66, 130)),
    "multiscale_flip": ((0.75, 1.0), True, -1, IMG_HW),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = JTrainConfig(blocks=BLOCKS, data_parallel=False)
    params, frozen = jinit(jax.random.key(3), jmodel_config(jcfg))
    model = DeepLabV2(model_config(TrainConfig(blocks=BLOCKS)))
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, frozen)))
    model = model.to(memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, size=(2, *IMG_HW, 3)).astype(np.uint8)
    return jcfg, params, frozen, model, x


def _labels(hw):
    return np.random.default_rng(5).integers(-1, 19, size=(2, *hw)).astype(np.int32)


def _confident(model, cfg, x, scales, flip, out_hw):
    """Pixels whose top-two (probability or logit) gap exceeds GAP."""
    xt, _ = _prepare_inputs(torch.from_numpy(x), None, cfg)
    with torch.inference_mode():
        prob = tta_prob_rows(model, xt, scales, flip, out_hw)(0, out_hw[0])
    top2 = prob.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy() > GAP


def _cm(gt, pred):
    ev = Eval(19)
    ev.add_batch(gt, pred)
    return ev


def _compare(want_arg, got_arg, y, confident):
    assert got_arg.shape == want_arg.shape
    assert confident.mean() > 0.9
    np.testing.assert_array_equal(got_arg[confident], want_arg[confident])
    y_conf = np.where(confident, y, -1)
    np.testing.assert_array_equal(_cm(y_conf, got_arg).confusion_matrix,
                                  _cm(y_conf, want_arg).confusion_matrix)
    assert abs(_cm(y, got_arg).Mean_Intersection_over_Union()
               - _cm(y, want_arg).Mean_Intersection_over_Union()) <= 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_eval_step_matches_jax(setup, case):
    jcfg, params, frozen, model, x = setup
    scales, flip, h_chunk, label_hw = CASES[case]
    y = _labels(label_hw)
    cfg = TrainConfig(blocks=BLOCKS, eval_h_chunk=h_chunk)
    jcm, jarg = jmake_step(jcfg, frozen, scales, flip, h_chunk=h_chunk)(
        params, jnp.asarray(x), jnp.asarray(y))
    if case == "single_scale":
        step = make_eval_step(cfg, model)
    else:
        step = make_multiscale_eval_step(cfg, model, scales, flip)
    cm, arg = step(torch.from_numpy(x), torch.from_numpy(y))
    assert cm.dtype == torch.int64 and arg.dtype == torch.int32
    assert cm.sum().item() == int((y >= 0).sum())
    np.testing.assert_array_equal(cm.numpy(), _cm(y, arg.numpy()).confusion_matrix)
    ev, jev = Eval(19), JEval(19)
    ev.add_confusion_matrix(cm)
    jev.add_confusion_matrix(np.asarray(jcm))
    assert abs(ev.Mean_Intersection_over_Union() - jev.Mean_Intersection_over_Union()) <= 1e-3
    confident = _confident(model, cfg, x, scales, flip, label_hw)
    _compare(np.asarray(jarg), arg.numpy(), y, confident)


@pytest.mark.parametrize("case", list(CASES))
def test_predict_matches_jax(setup, case):
    jcfg, params, frozen, model, x = setup
    scales, flip, h_chunk, out_hw = CASES[case]
    jcfg = JTrainConfig(blocks=BLOCKS, data_parallel=False, eval_h_chunk=h_chunk)
    cfg = TrainConfig(blocks=BLOCKS, eval_h_chunk=h_chunk)
    xj, _ = jprepare(jnp.asarray(x), None, jcfg)
    want = np.asarray(jax.jit(jmake_predict_fn(jcfg, frozen, scales, flip, out_hw))(params, xj))
    got = make_predict_fn(cfg, model, scales, flip, out_hw)(torch.from_numpy(x))
    assert got.dtype == torch.int32
    confident = _confident(model, cfg, x, scales, flip, out_hw)
    _compare(want, got.numpy(), _labels(out_hw), confident)
