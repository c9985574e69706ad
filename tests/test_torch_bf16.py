"""The port's bf16 compute (``--compute_dtype bfloat16``) and stage remat
(``--remat stages``) on the CPU at small sizes, against the JAX package
where it has the same function. Inputs come from seeded numpy generators;
weights are the JAX package's, carried across by ``convert``.

Tolerances (PERF.md section 2 states each with its reason):
- the bf16 block's plain version against the retired Pallas kernel in bf16
  (interpret mode), eval and emit (out, h1, h2): within 2 bf16 ulps of the
  largest magnitude; both round at the same points, only the fp32 sums'
  order differs;
- the bf16 block backward against the Pallas kernel's ``_bwd`` on the same
  saved tensors: dx and each dW within 1e-2 relative L2; dW comes back fp32;
- logits, port against JAX in bf16 from the same weights (the train heads
  against the JAX train path, the port's eval forward against the JAX eval
  path's ``aspp_matmul`` form): max abs difference <= 3e-2 of the largest
  |logit|, argmax agreement >= 98 %, both fp32;
- one UDA step in bf16, port against JAX: every metric within 1e-2
  relative; the metrics counted over the thresholded pseudo-label set
  (the guidance's valid share, the CE on its labels) and the IW weights'
  maximum, where a 1-ulp logit decides a pixel, within 1e-2 beyond the
  distance bf16 itself moves them in the JAX step (its bf16 metric against
  its fp32 one, 0.5-4 %); each parameter's change within 3e-2 relative L2;
  parameters and the loss fp32. The port's fp32 step misses these limits
  against the JAX bf16 step;
- 50 UDA steps, port bf16 against port fp32: the JAX package's own bounds
  (``tests/test_steps.py::test_bfloat16_trajectory_tracks_fp32``): per-step
  loss within 2 %, mean within 1 %, parameters within 5e-3 relative L2;

Stage remat, the CLIs and the bench in bf16: ``tests/test_torch_bf16_cli.py``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from experiments.retired_pallas import fused_block as pallas_block
from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.convert import state_dict_from_jax
from maxsquareloss_torch.kernels import fused_block
from maxsquareloss_torch.kernels.fused_block import (
    FusedBottleneckFn,
    bottleneck_backward,
    fused_bottleneck,
    fused_bottleneck_emit,
)
from maxsquareloss_torch.models import deeplabv2 as tmodel
from maxsquareloss_torch.train import steps as tsteps
from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
from maxsquareloss_tpu.models import deeplabv2 as jmodel
from maxsquareloss_tpu.train import steps as jsteps
from tests.test_torch_fused_block import _bn_args, _make_case

BLOCKS = (2, 2, 2, 2)
HW = (32, 64)
HEAD_SCALE = 40.0
BF16 = torch.bfloat16
# one shape for each of R101's (Cin, Cmid, d) identity-block triples, scaled
# down: (256, 64, 1), (512, 128, 1), (1024, 256, 2), (2048, 512, 4)
BLOCK_CASES = [
    (2, 9, 13, 64, 16, 1),
    (1, 8, 11, 128, 32, 1),
    (2, 10, 9, 128, 32, 2),
    (1, 9, 12, 256, 64, 4),
]
CONVS = ("conv1", "conv2", "conv3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_ulp(m: float) -> float:
    """One bf16 ulp at magnitude m (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(m)) - 7)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _to_np(t: torch.Tensor) -> np.ndarray:
    """An NCHW channels_last torch tensor as NHWC float32 numpy (exact for bf16)."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _block_inputs(n, h, w, cin, cmid, seed=7):
    """fp32 HWIO weights and BN vectors; x post-ReLU, exact in bf16 (NHWC)."""
    p, f, x = _make_case(np.random.default_rng(seed), n, h, w, cin, cmid)
    x = torch.from_numpy(np.maximum(x, 0)).to(BF16).float().numpy()
    return p, f, x


# -- the block ---------------------------------------------------------------


@pytest.mark.parametrize("emit", [False, True], ids=["eval", "emit"])
@pytest.mark.parametrize("n,h,w,cin,cmid,d", BLOCK_CASES)
def test_bf16_block_matches_the_pallas_kernel(n, h, w, cin, cmid, d, emit):
    p, f, x = _block_inputs(n, h, w, cin, cmid)
    bn = [jnp.asarray(v) for v in _bn_args(f)]
    ws = [jnp.asarray(p[k]) for k in CONVS]
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        if emit:
            xp = pallas_block.pad_for_fused(xj, d)
            out, res = pallas_block._fwd(xp, *ws, *bn, d, w)
            want = [pallas_block.unpad_from_fused(t, w) for t in (out, res[1], res[2])]
        else:
            want = [pallas_block.fused_bottleneck(xj, *ws, *bn, d)]
    assert all(t.dtype == jnp.bfloat16 for t in want)

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)
    wt = [torch.from_numpy(p[k]).to(BF16) for k in CONVS]
    bt = [torch.from_numpy(v) for v in _bn_args(f)]
    before = (fused_bottleneck.launches, fused_bottleneck_emit.launches)
    got = fused_bottleneck_emit(xt, *wt, *bt, d) if emit else [fused_bottleneck(xt, *wt, *bt, d)]
    assert (fused_bottleneck.launches, fused_bottleneck_emit.launches) == before  # CPU: plain
    for name, g, want_t in zip(("out", "h1", "h2"), got, want):
        assert g.dtype == BF16 and g.is_contiguous(memory_format=torch.channels_last)
        want_np = np.asarray(want_t.astype(jnp.float32))
        scale = float(np.abs(want_np).max())
        assert scale > 0
        err = float(np.abs(_to_np(g) - want_np).max())
        assert err <= 2 * _bf16_ulp(scale), f"{name}: {err} > 2 ulps of {scale}"


@pytest.mark.parametrize("n,h,w,cin,cmid,d", BLOCK_CASES)
def test_bf16_block_backward_matches_pallas_bwd(n, h, w, cin, cmid, d):
    """``bottleneck_backward`` in bf16 against the Pallas kernel's ``_bwd``
    on the same saved tensors (the port's plain bf16 emit): dx in bf16, the
    weight gradients fp32, each within 1e-2 relative L2."""
    p, f, x = _block_inputs(n, h, w, cin, cmid, seed=9)
    dy = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)
    dy = torch.from_numpy(dy).to(BF16).float().numpy()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)
    wt = [torch.from_numpy(p[k]).to(BF16) for k in CONVS]
    s1, b1, s2, b2, s3, b3 = (torch.from_numpy(v) for v in _bn_args(f))
    out, h1, h2 = fused_bottleneck_emit(xt, *wt, s1, b1, s2, b2, s3, b3, d)
    got = bottleneck_backward(torch.from_numpy(dy).permute(0, 3, 1, 2).to(BF16), xt, h1, h2,
                              out, *wt, s1, s2, s3, d)
    assert got[0].dtype == BF16 and all(g.dtype == torch.float32 for g in got[1:])

    def j(t):
        return jnp.asarray(_to_np(t)).astype(jnp.bfloat16)

    res = (j(xt), j(h1), j(h2), j(out), *(jnp.asarray(p[k]) for k in CONVS),
           *(jnp.asarray(v.numpy()) for v in (s1, s2, s3)))
    want = pallas_block._bwd(d, w, res, jnp.asarray(dy).astype(jnp.bfloat16))
    assert want[0].dtype == jnp.bfloat16 and all(t.dtype == jnp.float32 for t in want[1:4])
    assert _rel_l2(_to_np(got[0]), np.asarray(want[0].astype(jnp.float32))) <= 1e-2
    for k, g, wj in zip(CONVS, got[1:], want[1:4]):
        assert g.shape == wj.shape
        assert _rel_l2(g.numpy(), np.asarray(wj)) <= 1e-2, k


def test_block_function_returns_fp32_weight_gradients():
    """``FusedBottleneckFn`` on bf16 x and the fp32 HWIO parameters: bf16 out,
    the fp32 weights' gradients fp32 (no round trip through bf16), the
    plain version's autograd within 1e-2 relative L2."""
    p, f, x = _block_inputs(2, 9, 11, 64, 16, seed=11)
    bt = [torch.from_numpy(v) for v in _bn_args(f)]
    cot = torch.from_numpy(np.random.default_rng(12).normal(size=x.shape).astype(np.float32))
    cot = cot.permute(0, 3, 1, 2).to(BF16)
    grads = []
    for fn in (FusedBottleneckFn.apply, fused_block.fused_bottleneck_reference):
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16).requires_grad_(True)
        ws = [torch.from_numpy(p[k].copy()).requires_grad_(True) for k in CONVS]
        out = fn(xt, *ws, *bt, 2)
        assert out.dtype == BF16
        out.backward(cot)
        grads.append([xt.grad, *(t.grad for t in ws)])
    assert [g.dtype for g in grads[0]] == [BF16] + [torch.float32] * 3
    for g, want in zip(*grads):
        assert _rel_l2(g.float().numpy(), want.float().numpy()) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_wrapper_names_a_type_it_has_no_instance_for(dtype):
    p, f, x = _block_inputs(1, 5, 6, 64, 16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    ws = [torch.from_numpy(p[k]).to(dtype) for k in CONVS]
    bt = [torch.from_numpy(v) for v in _bn_args(f)]
    for fn in (fused_bottleneck, fused_bottleneck_emit):
        with pytest.raises(TypeError, match=str(dtype)):
            fn(xt, *ws, *bt, 1)


def test_kernel_wrapper_wants_the_kernels_in_x_dtype():
    p, f, x = _block_inputs(1, 5, 6, 64, 16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)
    ws = [torch.from_numpy(p[k]) for k in CONVS]  # fp32: the Function casts, the wrapper not
    bt = [torch.from_numpy(v) for v in _bn_args(f)]
    with pytest.raises(TypeError, match="w1 is torch.float32"):
        fused_bottleneck(xt, *ws, *bt, 1)
    with pytest.raises(TypeError, match="s1 is torch.bfloat16"):
        fused_bottleneck(xt, *(w.to(BF16) for w in ws), *(v.to(BF16) for v in bt), 1)


# -- the model -----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_weights():
    """JAX-initialised weights at BLOCKS, heads scaled up (peaked softmax,
    logits well above bf16's rounding), BN randomised."""
    mcfg = jmodel.DeepLabV2Config(num_classes=19, multi_level=True, blocks=BLOCKS)
    params, frozen = jmodel.init_deeplabv2(jax.random.key(0), mcfg)
    params = jax.tree.map(np.array, params)
    for head in ("layer5", "layer6"):
        for conv in params[head]["convs"]:
            conv["w"] = conv["w"] * HEAD_SCALE
    rng = np.random.default_rng(21)
    frozen = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, size=v.shape).astype(np.float32), frozen)
    return params, frozen


def _port_model(params, frozen, **cfg_kw):
    cfg = TrainConfig(blocks=BLOCKS, **cfg_kw)
    model = tmodel.DeepLabV2(tsteps.model_config(cfg))
    model.load_state_dict(state_dict_from_jax(params, frozen))
    return model.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("heads", ["train", "eval"])
def test_bf16_logits_match_jax(jax_weights, heads):
    """The port's bf16 forward against ``apply_deeplabv2`` in bf16: the
    training forward (grad on) against the JAX train path, the eval forward
    against the JAX eval path (``aspp_matmul``: the ASPP taps summed in
    fp32, which the port does not mirror)."""
    params, frozen = jax_weights
    x = np.random.default_rng(12).normal(0, 50, size=(2, 64, 128, 3)).astype(np.float32)
    jcfg = jmodel.DeepLabV2Config(num_classes=19, blocks=BLOCKS, compute_dtype=jnp.bfloat16,
                                  aspp_matmul=heads == "eval")
    want = jmodel.apply_deeplabv2(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, frozen), jnp.asarray(x), jcfg)
    model = _port_model(params, frozen, compute_dtype="bfloat16")
    ctx = torch.enable_grad() if heads == "train" else torch.inference_mode()
    with ctx:
        got = model(torch.from_numpy(x))
    for g, wj in zip(got, want):
        assert g.dtype == torch.float32 and wj.dtype == jnp.float32
        g, wn = g.detach().numpy(), np.asarray(wj)
        scale = float(np.abs(wn).max())
        assert float(np.abs(g - wn).max()) <= 3e-2 * scale
        assert float((g.argmax(-1) == wn.argmax(-1)).mean()) >= 0.98


def test_bf16_eval_weights_follow_the_convs(jax_weights):
    """The identity blocks' packed HWIO weights are the conv weights cast to
    bf16, on load and after a train step's update; the parameters stay fp32."""
    model = _port_model(*jax_weights, compute_dtype="bfloat16")
    cfg = TrainConfig(blocks=BLOCKS, iter_max=100, compute_dtype="bfloat16")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, *HW, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(-1, 19, (2, *HW)).astype(np.int32))
    for stage in ("load", "step"):
        if stage == "step":
            tsteps.make_supervised_train_step(cfg)(tsteps.make_train_state(model, cfg), x, y)
        blocks = [b for layer in (model.layer1, model.layer2, model.layer3, model.layer4)
                  for b in layer if b.fusable]
        assert len(blocks) == 4
        for b in blocks:
            for i in (1, 2, 3):
                conv = getattr(b, f"conv{i}").weight
                assert conv.dtype == torch.float32
                assert torch.equal(b._hwio(i), conv.detach().permute(2, 3, 1, 0).to(BF16)), stage
    assert not any("hwio" in k for k in model.state_dict())


# -- one step against the JAX package -----------------------------------------------


def _step_batches(n_steps, seed=22, src_hw=(33, 65), tgt_hw=(25, 49), batch=2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (batch, *src_hw, 3)).astype(np.float32),
             rng.integers(-1, 19, (batch, *src_hw)).astype(np.int32),
             rng.normal(0, 1, (batch, *tgt_hw, 3)).astype(np.float32))
            for _ in range(n_steps)]


def _port_steps(model, cfg, batches, uda=True):
    """The port's steps over ``batches``: (metrics a step, parameters after)."""
    state = tsteps.make_train_state(model, cfg)
    step = (tsteps.make_uda_train_step if uda else tsteps.make_supervised_train_step)(cfg)
    metrics = []
    for xs, ys, xt in batches:
        args = (xs, ys, xt) if uda else (xs, ys)
        state, m = step(state, *(torch.from_numpy(a) for a in args))
        assert m["loss"].dtype == torch.float32
        metrics.append({k: v.item() for k, v in m.items()})
    return metrics, {n: p.detach().clone() for n, p in model.named_parameters()}


# the metrics counted over the thresholded pseudo-label set, which a 1-ulp
# logit decides a pixel of (the guidance's valid share, the CE on its labels:
# the aux head's and ``hard``'s target loss) and the IW weights' maximum:
# 1e-2 relative beyond the distance bf16 itself moves them in the JAX step
THRESHOLDED = {
    "IW_maxsquare": {"guidance_valid_frac", "loss_target_aux", "iw_pixel_w_max"},
    "hard": {"guidance_valid_frac", "loss_target_aux", "loss_target", "loss_target_raw"},
}
STEP_RTOL, STEP_PARAM_RTOL_L2 = 1e-2, 3e-2


@pytest.fixture(scope="module")
def jax_uda_steps(jax_weights):
    """The JAX package's UDA step in fp32 and bf16 from ``jax_weights`` on
    one batch, per target mode (computed once): ({dtype: metrics}, the
    port's state dict after the bf16 step)."""
    params, frozen = jax_weights
    out = {}

    def run(mode):
        if mode not in out:
            jm = {}
            for dtype in ("float32", "bfloat16"):
                jcfg = JTrainConfig(data_parallel=False, compute_dtype=dtype, **_step_kw(mode))
                jstate, jm[dtype] = jsteps.make_uda_train_step(jcfg, frozen)(
                    jsteps.make_train_state(jax.tree.map(jnp.array, params)),
                    *(jnp.asarray(a) for a in _step_batches(1)[0]))
            assert jm["bfloat16"]["loss"].dtype == jnp.float32
            out[mode] = jm, state_dict_from_jax(jax.tree.map(np.array, jstate.params), frozen)
        return out[mode]

    return run


def _step_kw(mode):
    return dict(blocks=BLOCKS, iter_max=100, threshold=0.5, target_mode=mode)


def _bf16_step_misses(jax_weights, jax_uda_steps, mode, port_dtype) -> list[str]:
    """The port's UDA step in ``port_dtype`` against the JAX package's bf16
    step from the same weights: each limit it misses. Every metric within
    STEP_RTOL relative (plus, for the THRESHOLDED ones, the JAX bf16
    metric's distance from its fp32 one); each parameter's change within
    STEP_PARAM_RTOL_L2 relative L2."""
    params, frozen = jax_weights
    jm, j_after = jax_uda_steps(mode)
    model = _port_model(params, frozen, compute_dtype=port_dtype)
    (tm,), t_after = _port_steps(model, TrainConfig(compute_dtype=port_dtype, **_step_kw(mode)),
                                 _step_batches(1))
    assert set(tm) == set(jm["bfloat16"])
    misses = []
    for k in tm:
        want, fp32 = float(jm["bfloat16"][k]), float(jm["float32"][k])
        rtol = STEP_RTOL
        if k in THRESHOLDED[mode]:
            rtol += abs(want - fp32) / max(abs(want), 1e-30)
        if not abs(tm[k] - want) <= rtol * abs(want) + 1e-7:
            misses.append(f"{k}: {tm[k]} vs {want} (rtol {rtol:.3g})")
    p0 = state_dict_from_jax(params, frozen)
    for name, p1 in t_after.items():
        assert p1.dtype == torch.float32, name
        want = j_after[name].double() - p0[name].double()
        err = float(((p1.double() - p0[name].double()) - want).norm() / want.norm())
        if not err <= STEP_PARAM_RTOL_L2:
            misses.append(f"{name}: change off by {err:.3g} (relative L2)")
    return misses


@pytest.mark.parametrize("mode", ["IW_maxsquare", "hard"])
def test_bf16_uda_step_matches_jax(jax_weights, jax_uda_steps, mode):
    assert _bf16_step_misses(jax_weights, jax_uda_steps, mode, "bfloat16") == []


@pytest.mark.parametrize("mode", ["IW_maxsquare", "hard"])
def test_fp32_step_misses_the_bf16_step_limits(jax_weights, jax_uda_steps, mode):
    """The limits above tell the compute dtypes apart: the port's fp32 step
    misses at least one of them against the JAX bf16 step (IW_maxsquare:
    the IW metrics and the parameter changes; hard: the parameter changes,
    0.118 relative L2 at worst)."""
    assert _bf16_step_misses(jax_weights, jax_uda_steps, mode, "float32") != []


def test_bf16_trajectory_tracks_fp32():
    """The port's counterpart of the JAX package's
    ``test_bfloat16_trajectory_tracks_fp32``, with its bounds: 50 UDA steps
    (IW_maxsquare, threshold 0.5, 2 + 2 images at 32x64) from the same
    JAX-drawn weights, bf16 against fp32."""
    batches = _step_batches(50, seed=0, src_hw=HW, tgt_hw=HW)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = TrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5, target_mode="IW_maxsquare",
                          compute_dtype=dtype, device="cpu")
        model = tmodel.init_deeplabv2(tsteps.model_config(cfg), 0, device="cpu")
        metrics, after = _port_steps(model, cfg, batches)
        runs[dtype] = (np.asarray([m["loss"] for m in metrics]), after)
    (fp32, p32), (bf16, p16) = runs["float32"], runs["bfloat16"]
    rel = np.abs(bf16 - fp32) / np.maximum(np.abs(fp32), 1e-3)
    assert rel.max() < 0.02, f"max rel divergence {rel.max():.4f}"
    assert rel.mean() < 0.01, f"mean rel divergence {rel.mean():.4f}"
    assert all(p.dtype == torch.float32 for p in (*p32.values(), *p16.values()))
    flat32 = torch.cat([p.flatten() for p in p32.values()]).double()
    flat16 = torch.cat([p16[n].flatten() for n in p32]).double()
    assert float((flat16 - flat32).norm() / flat32.norm()) < 5e-3
