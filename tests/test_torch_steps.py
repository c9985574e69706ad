"""The port's train steps against the JAX package's, from the same weights
(JAX init, carried across by ``convert.state_dict_from_jax``, which also
carries the JAX step's trained parameters across for the comparison) on
the same seeded numpy batches: every ``--target_mode`` with and without the aux head,
plus ``--iw_hist argmax``, ``--guidance_mask per_head_or`` and
``--concat_batches`` (unequal and equal crops), and the supervised step. ``blocks=(2,2,2,2)`` gives every layer an identity block,
so the fused block's backward is on the path; the heads are scaled up so
that the softmax is peaked enough for the guidance threshold to pass on
some pixels.

Tolerances: over 6 steps, each step's loss and every metric rtol 5e-4
(fp32 through ~30 convs and their adjoints, the error grows with the
steps); after step 1, every parameter's change within a relative L2
error of 1e-3 of the JAX step's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
from maxsquareloss_tpu.models import deeplabv2 as jmodel
from maxsquareloss_tpu.train import steps as jsteps
from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.convert import state_dict_from_jax
from maxsquareloss_torch.models import deeplabv2 as tmodel
from maxsquareloss_torch.train import steps as tsteps

BLOCKS = (2, 2, 2, 2)
SRC_HW, TGT_HW = (33, 65), (25, 49)  # unequal crops, as the GTA5 protocol
STEPS = 6
HEAD_SCALE = 40.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: these steps are small, so more threads gain
    little, and the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg_kw(**kw):
    return {"blocks": BLOCKS, "iter_max": 100, "threshold": 0.5, **kw}


@pytest.fixture(scope="module")
def jax_weights():
    """JAX-initialised weights per multi-level flag (single-level: the same
    without the aux head ``layer5``), BN biases randomised."""
    mcfg = jmodel.DeepLabV2Config(num_classes=19, multi_level=True, blocks=BLOCKS)
    params, frozen = jmodel.init_deeplabv2(jax.random.key(0), mcfg)
    params = jax.tree.map(np.array, params)
    for head in ("layer5", "layer6"):
        for conv in params[head]["convs"]:
            conv["w"] = conv["w"] * HEAD_SCALE
    rng = np.random.default_rng(21)
    frozen = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, size=v.shape).astype(np.float32),
        frozen,
    )
    single = {k: v for k, v in params.items() if k != "layer5"}
    return {True: (params, frozen), False: (single, frozen)}


def _batches(seed=22, tgt_hw=TGT_HW):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (2, *SRC_HW, 3)).astype(np.float32),
             rng.integers(-1, 19, (2, *SRC_HW)).astype(np.int32),
             rng.normal(0, 1, (2, *tgt_hw, 3)).astype(np.float32))
            for _ in range(STEPS)]


def _port_model(params, frozen, multi):
    cfg = tmodel.DeepLabV2Config(num_classes=19, multi_level=multi, blocks=BLOCKS)
    model = tmodel.DeepLabV2(cfg)
    model.load_state_dict(state_dict_from_jax(params, frozen))
    return model.to(memory_format=torch.channels_last)


def _run_jax(cfg, params, frozen, batches, uda):
    step = (jsteps.make_uda_train_step if uda else jsteps.make_supervised_train_step)(cfg, frozen)
    state = jsteps.make_train_state(jax.tree.map(jnp.array, params))
    metrics, after_1 = [], None
    for xs, ys, xt in batches:
        args = (jnp.asarray(xs), jnp.asarray(ys)) + ((jnp.asarray(xt),) if uda else ())
        state, m = step(state, *args)
        metrics.append({k: float(v) for k, v in m.items()})
        if after_1 is None:
            after_1 = state_dict_from_jax(jax.tree.map(np.array, state.params), frozen)
    return metrics, after_1


def _run_port(cfg, params, frozen, batches, uda):
    model = _port_model(params, frozen, cfg.multi)
    state = tsteps.make_train_state(model, cfg)
    step = (tsteps.make_uda_train_step if uda else tsteps.make_supervised_train_step)(cfg)
    metrics, after_1 = [], None
    for xs, ys, xt in batches:
        args = (torch.from_numpy(xs), torch.from_numpy(ys)) + ((torch.from_numpy(xt),) if uda else ())
        state, m = step(state, *args)
        assert all(v.dim() == 0 and v.dtype == torch.float32 for v in m.values())
        metrics.append({k: v.item() for k, v in m.items()})
        if after_1 is None:
            after_1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert state.iteration == len(batches)
    return metrics, after_1


def _compare(cfg_kw, weights, uda, tgt_hw=TGT_HW):
    params, frozen = weights[cfg_kw["multi"]]
    batches = _batches(tgt_hw=tgt_hw)
    jm, j1 = _run_jax(JTrainConfig(data_parallel=False, **cfg_kw), params, frozen, batches, uda)
    tm, t1 = _run_port(TrainConfig(**cfg_kw), params, frozen, batches, uda)
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j), f"step {i}: metrics {sorted(t)} vs {sorted(j)}"
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=5e-4, atol=1e-7, err_msg=f"step {i} {k}")
    p0 = state_dict_from_jax(params, frozen)
    assert t1 and set(t1) <= set(j1)
    for name, p1 in t1.items():
        want = j1[name].double() - p0[name].double()
        err = ((p1.double() - p0[name].double()) - want).norm() / want.norm()
        assert err <= 1e-3, f"{name}: change off by {err:.3g} (relative L2)"
    assert abs(tm[0]["loss"] - tm[-1]["loss"]) > 1e-5  # training moves the loss
    return tm


UDA_CASES = [
    {"target_mode": mode, "multi": multi}
    for mode in ("IW_maxsquare", "maxsquare", "entropy", "IW_entropy", "hard")
    for multi in (True, False)
] + [
    {"target_mode": "IW_maxsquare", "multi": True, "iw_hist": "argmax"},
    {"target_mode": "IW_maxsquare", "multi": True, "guidance_mask": "per_head_or"},
    # no pixel clears the threshold: the guidance CE over an all-ignored
    # label is 0 (torch's CE would be NaN) and every IW weight is 1.0
    {"target_mode": "IW_maxsquare", "multi": True, "threshold": 0.9},
    # one canvas forward over both batches: at the unequal crops (masked)
    # and at equal crops (no masks)
    {"target_mode": "IW_maxsquare", "multi": True, "concat_batches": True},
    {"target_mode": "IW_maxsquare", "multi": True, "concat_batches": True,
     "tgt_hw": SRC_HW},
]


@pytest.mark.parametrize("case", UDA_CASES, ids=lambda c: "-".join(str(v) for v in c.values()))
def test_uda_step_matches_jax(jax_weights, case):
    case = dict(case)
    tgt_hw = case.pop("tgt_hw", TGT_HW)
    tm = _compare(_cfg_kw(**case), jax_weights, uda=True, tgt_hw=tgt_hw)
    if case.get("threshold") == 0.9:
        assert tm[0]["guidance_valid_frac"] == 0.0 == tm[0]["loss_target_aux"]
        assert tm[0]["iw_pixel_w_max"] == 1.0
    elif case["multi"]:  # the guidance path is exercised, not all-ignored
        assert tm[0]["guidance_valid_frac"] > 0.0


@pytest.mark.parametrize("multi", [True, False])
def test_supervised_step_matches_jax(jax_weights, multi):
    _compare(_cfg_kw(multi=multi), jax_weights, uda=False)


def test_step_trains_identity_blocks_and_eval_reads_them(jax_weights):
    """Regression: every identity block's conv{1,2,3}.weight gets a
    gradient and moves in one UDA step, and the eval forward afterwards
    (no grad: the packed kernel weights) equals a fresh model loaded from
    the updated state dict."""
    params, frozen = jax_weights[True]
    model = _port_model(params, frozen, True)
    cfg = TrainConfig(**_cfg_kw(multi=True))
    fused = [b for layer in (model.layer1, model.layer2, model.layer3, model.layer4)
             for b in layer if b.fusable]
    assert len(fused) == 4
    before = [[getattr(b, f"conv{i}").weight.detach().clone() for i in (1, 2, 3)] for b in fused]
    xs, ys, xt = _batches()[0]
    tsteps.make_uda_train_step(cfg)(tsteps.make_train_state(model, cfg), torch.from_numpy(xs),
                                    torch.from_numpy(ys), torch.from_numpy(xt))
    for b, ws in zip(fused, before):
        for i, w0 in zip((1, 2, 3), ws):
            conv = getattr(b, f"conv{i}")
            assert conv.weight.grad is not None and conv.weight.grad.abs().sum() > 0
            assert not torch.equal(conv.weight.detach(), w0)
    fresh = tmodel.DeepLabV2(model.cfg)
    fresh.load_state_dict(model.state_dict())
    fresh = fresh.to(memory_format=torch.channels_last)
    x = torch.from_numpy(xt)
    with torch.inference_mode():
        for got, want in zip(model(x), fresh(x)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

