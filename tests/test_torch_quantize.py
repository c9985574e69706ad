"""The port's int8 post-training quantization (``models/quantize.py``,
``layers.qconv2d``) and the ASPP heads' eval form, against the JAX package
on the CPU at a small depth. Inputs come from seeded numpy generators;
weights are the JAX package's, carried across by ``convert``.

Tolerances (PERF.md section 2 states each with its reason):
- ``qconv2d`` at every site kind (the stem's 7x7 stride 2, 1x1 stride 1
  and 2, 3x3 at dilation 1, 2 and 4) from the same int8 site, fp32 and
  bf16: bitwise (the int32 sum is exact; quantize and dequant are the same
  float32 operations);
- ``quantize_params``: the int8 weights, ``oscale`` and ``ascale_inv``
  bitwise from the same fp weights and ranges;
- ``calibrate``: every site's range within 1e-5 relative of the JAX
  package's, amax and percentile (the forwards sum in other orders);
- ``quantize.percentile`` against ``jnp.percentile``: equal, over sizes from
  2 to 3 million and percentiles from 37.3 to 100;
- the whole int8 forward from the same JAX-quantized weights, both heads:
  fp32 within 1e-3 of the largest logit, argmax agreement >= 99.9 % (a
  float32 activation one ulp off a rounding boundary of the int8 grid moves
  one input by one step; read 6.0e-7, 100 %); bf16 within 3.5e-4, argmax
  >= 99.9 % (twice the 1.7e-4 read, 100 % read);
- the heads' eval form against ``_aspp_matmul_forward`` on the same
  features: fp32 1e-6 of the largest logit, bf16 one bf16 ulp of the
  largest tap product (the product rounds once to bf16 after an fp32 sum
  in another order; the fp32 tree is the same).
"""

from __future__ import annotations

import json
import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.convert import model_from_jax, state_dict_from_jax
from maxsquareloss_torch.models import deeplabv2 as tmodel
from maxsquareloss_torch.models import quantize as tq
from maxsquareloss_torch.models.layers import QConv2d, aspp_matmul_forward
from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.train import steps as tsteps
from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
from maxsquareloss_tpu.models import deeplabv2 as jmodel
from maxsquareloss_tpu.models import layers as jlayers
from maxsquareloss_tpu.models import quantize as jq
from maxsquareloss_tpu.train.steps import model_config as jmodel_config

BLOCKS = (1, 1, 2, 1)
HW = (65, 65)
# (name, kernel, Cin, Cout, stride, dilation): every kind of site R101 has
SITES = [
    ("stem_7x7_s2", 7, 3, 16, 2, 1),
    ("1x1_s1", 1, 32, 24, 1, 1),
    ("1x1_s2", 1, 32, 24, 2, 1),
    ("3x3_d1", 3, 16, 16, 1, 1),
    ("3x3_d2", 3, 16, 16, 1, 2),
    ("3x3_d4", 3, 16, 16, 1, 4),
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX package's small model (BN randomised), its calibration over two
    batches and its int8 tree, as numpy."""
    cfg = JTrainConfig(blocks=BLOCKS, compute_dtype="float32")
    mcfg = jmodel_config(cfg, eval_mode=True)
    params, frozen = jmodel.init_deeplabv2(jax.random.key(5), mcfg)
    rng = np.random.default_rng(6)
    frozen = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, size=v.shape).astype(np.float32), frozen)
    params = jax.tree.map(np.asarray, params)
    xs = [rng.normal(0, 40, size=(2, *HW, 3)).astype(np.float32) for _ in range(2)]
    amax = jq.calibrate(params, frozen, cfg, xs, mcfg=mcfg)
    qparams = jax.tree.map(np.asarray, jq.quantize_params(params, amax))
    return params, frozen, xs, amax, qparams


def _port_model(params, frozen, **cfg_kw):
    cfg = TrainConfig(blocks=BLOCKS, **cfg_kw)
    model = tmodel.DeepLabV2(tsteps.model_config(cfg, eval_mode=True))
    model.load_state_dict(state_dict_from_jax(params, frozen))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_qconv2d_is_the_jax_int8_conv_bitwise(site, dtype):
    _, k, cin, cout, stride, d = site
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(k * 10 + d + stride)
    w = rng.normal(0, 0.1, size=(k, k, cin, cout)).astype(np.float32)
    x = rng.normal(0, 2.0, size=(2, 19, 23, cin)).astype(np.float32)
    padding = d * (k // 2)
    jsite = jq._quantize_site({"w": jnp.asarray(w)}, float(np.abs(x).max()) * 0.7)
    want = np.asarray(jlayers.qconv2d(jnp.asarray(x, jdt), jsite, stride, padding, d)
                      .astype(jnp.float32))
    port = QConv2d(torch.from_numpy(np.asarray(jsite["w"]).transpose(3, 2, 0, 1).copy()),
                   torch.from_numpy(np.asarray(jsite["oscale"])),
                   torch.tensor(np.asarray(jsite["ascale_inv"])), stride, padding, d)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    got = port(xt.contiguous(memory_format=torch.channels_last))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(), want)


def test_quantize_params_is_the_jax_trees_bitwise(jax_model):
    params, frozen, _, amax, qparams = jax_model
    model = _port_model(params, frozen)
    qmodel = tq.quantize_params(model, amax)
    jsites = dict(jq.iter_conv_sites(qparams))
    sites = dict(tq.iter_conv_sites(qmodel))
    assert list(sites) == list(jsites)
    for path, site in sites.items():
        assert isinstance(site, QConv2d), path
        kh, kw, cin, cout = jsites[path]["w"].shape  # w_mat: (Cout, taps in HWI order, 0 pad)
        k = kh * kw * cin
        np.testing.assert_array_equal(
            site.w_mat[:, :k].view(cout, kh, kw, cin).permute(1, 2, 3, 0).numpy(),
            jsites[path]["w"])
        assert site.w_mat.shape[1] % 8 == 0 and not site.w_mat[:, k:].any()
        np.testing.assert_array_equal(site.oscale.numpy(), jsites[path]["oscale"])
        np.testing.assert_array_equal(site.ascale_inv.numpy(), jsites[path]["ascale_inv"])
    # the heads stay float and shared values; the model quantized from is untouched
    assert qmodel.quantized and not model.quantized
    for head in ("layer5", "layer6"):
        for a, b in zip(getattr(qmodel, head).parameters(), getattr(model, head).parameters()):
            assert torch.equal(a, b)
    assert all(b.w1_hwio is None for b in qmodel.layer3 if b.fusable)
    with pytest.raises(ValueError, match="no calibration amax"):
        tq.quantize_params(model, {k: v for k, v in amax.items() if k != "conv1"})


@pytest.mark.parametrize("mode", ["amax", "p99.9"])
def test_calibrate_matches_jax(jax_model, mode):
    params, frozen, xs, _, _ = jax_model
    cfg = JTrainConfig(blocks=BLOCKS, compute_dtype="float32")
    want = jq.calibrate(params, frozen, cfg, xs, mcfg=jmodel_config(cfg, eval_mode=True),
                        mode=mode)
    got = tq.calibrate(_port_model(params, frozen), TrainConfig(blocks=BLOCKS), xs, mode=mode)
    assert list(got) == [p for p, _ in jq.iter_conv_sites(params)] and set(got) == set(want)
    for path, v in want.items():
        assert abs(got[path] - v) <= 1e-5 * v, (path, got[path], v)


def test_calibrate_runs_the_identity_blocks_as_the_emit_kernel(jax_model, monkeypatch):
    """Calibration takes conv2's and conv3's inputs of each identity block
    from the fused kernel's training forward (its wrapper, which launches
    the kernel on the card), once a block and batch; the ranges equal those
    a ``plain_blocks`` model records through the plain version."""
    params, frozen, xs, _, _ = jax_model
    calls = []
    emit = tmodel.fused_bottleneck_emit

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return emit(*args)

    monkeypatch.setattr(tmodel, "fused_bottleneck_emit", counted)
    model = _port_model(params, frozen)
    got = tq.calibrate(model, TrainConfig(blocks=BLOCKS), xs)
    plain = tmodel.DeepLabV2(model.cfg, plain_blocks=True)
    plain.load_state_dict(model.state_dict())
    want = tq.calibrate(plain.to(memory_format=torch.channels_last), TrainConfig(blocks=BLOCKS),
                        xs)
    fusable = [b for b in model.modules() if isinstance(b, tmodel.Bottleneck) and b.fusable]
    assert len(fusable) == 1 and len(calls) == len(xs)
    assert got == want


def test_percentile_matches_jnp_percentile():
    rng = np.random.default_rng(8)
    for n in (2, 3, 10, 1000, 4099, 65537, 100003, 3000001):
        a = np.abs(rng.normal(0, 3, size=n)).astype(np.float32)
        for q in (37.3, 50.0, 99.0, 99.9, 99.99, 99.999, 100.0):
            want = np.float32(jnp.percentile(jnp.asarray(a), q))
            assert tq.percentile(torch.from_numpy(a), q).item() == want, (n, q)


def test_parse_calib_mode_and_sites(jax_model):
    assert tq.parse_calib_mode("amax") is None
    assert tq.parse_calib_mode("p99.9") == 99.9
    assert tq.parse_calib_mode("p999") == 99.9
    assert tq.parse_calib_mode("p9999") == 99.99
    for bad in ("max", "p0", "p-5", "q99"):
        with pytest.raises(ValueError):
            tq.parse_calib_mode(bad)
    params, frozen = jax_model[:2]
    assert [p for p, _ in tq.iter_conv_sites(_port_model(params, frozen))] == [
        p for p, _ in jq.iter_conv_sites(params)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_forward_matches_jax(jax_model, dtype):
    """The same JAX-quantized weights through both packages' eval forward."""
    _, frozen, xs, _, qparams = jax_model
    tdt, jdt = DTYPES[dtype]
    jcfg = jmodel.DeepLabV2Config(num_classes=19, blocks=BLOCKS, compute_dtype=jdt,
                                  aspp_matmul=True)
    want = jmodel.apply_deeplabv2(jax.tree.map(jnp.asarray, qparams),
                                  jax.tree.map(jnp.asarray, frozen), jnp.asarray(xs[0]), jcfg)
    mcfg = tsteps.model_config(TrainConfig(blocks=BLOCKS, compute_dtype=dtype), eval_mode=True)
    model = model_from_jax(qparams, frozen, mcfg)
    assert model.quantized and isinstance(model.layer3[1].conv2, QConv2d)
    with torch.inference_mode():
        got = model(torch.from_numpy(xs[0]))
    tol, agree = INT8_FORWARD_LIMITS[dtype]
    for g, wj in zip(got, want):
        g, wn = g.numpy(), np.asarray(wj)
        scale = float(np.abs(wn).max())
        assert float(np.abs(g - wn).max()) <= tol * scale
        assert float((g.argmax(-1) == wn.argmax(-1)).mean()) >= agree


# (max abs difference over the largest |logit|, argmax agreement): fp32 the
# stated 1e-3 and 99.9 % (read: 6.0e-7, 100 %); bf16 twice the 1.7e-4 read
# (100 % agreement read)
INT8_FORWARD_LIMITS = {"float32": (1e-3, 0.999), "bfloat16": (3.5e-4, 0.999)}


def test_an_int8_model_does_not_train(jax_model):
    _, frozen, _, _, qparams = jax_model
    model = model_from_jax(qparams, frozen, tsteps.model_config(TrainConfig(blocks=BLOCKS)))
    with pytest.raises(ValueError, match="does not train"):
        tsteps.make_train_state(model, TrainConfig(blocks=BLOCKS))


def test_quantize_from_loader_reads_calib_batches(jax_model):
    params, frozen = jax_model[:2]
    seen = []

    class Loader:
        def __iter__(self):
            rng = np.random.default_rng(3)
            for i in range(5):
                seen.append(i)
                yield (rng.normal(0, 40, (1, *HW, 3)).astype(np.float32),
                       np.zeros((1, *HW), np.int8), [f"s{i}"])

    qmodel = tq.quantize_from_loader(TrainConfig(blocks=BLOCKS, calib_batches=2),
                                     _port_model(params, frozen), Loader())
    assert qmodel.quantized and seen == [0, 1]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_aspp_eval_form_matches_jax(dtype):
    """The heads' eval form alone against ``_aspp_matmul_forward`` on the
    same features, and against the training form in fp32."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, size=(2, 9, 13, 64)).astype(np.float32)
    ws = [rng.normal(0, 0.05, size=(3, 3, 64, 19)).astype(np.float32) for _ in range(4)]
    bs = [rng.normal(0, 0.1, size=19).astype(np.float32) for _ in range(4)]
    dil = tmodel.ASPP_DILATIONS
    xj = jnp.asarray(x, jdt)
    want = np.asarray(jlayers._aspp_matmul_forward(xj, [jnp.asarray(w) for w in ws],
                                                   [jnp.asarray(b) for b in bs], dil))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    wt = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws]
    got = aspp_matmul_forward(xt, wt, [torch.from_numpy(b) for b in bs], dil)
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(want).max())
    if dtype == "float32":
        assert float(np.abs(got - want).max()) <= 1e-6 * scale
        head = tmodel.Classifier(64, 19)
        with torch.no_grad():
            for conv, w, b in zip(head.conv2d_list, wt, bs):
                conv.weight.copy_(w)
                conv.bias.copy_(torch.from_numpy(b))
            train_form = head(xt).permute(0, 2, 3, 1).numpy()
            assert float(np.abs(train_form - got).max()) <= 1e-6 * scale
    else:
        z = np.abs(np.einsum("nhwc,ck->nhwk", x, np.concatenate(
            [w[a, b] for w in ws for a in range(3) for b in range(3)], axis=-1))).max()
        ulp = 2.0 ** (np.floor(np.log2(z)) - 7)
        assert float(np.abs(got - want).max()) <= ulp


def _site_ranges() -> tuple[list[dict], torch.nn.Module]:
    """Each rank's calibration ranges over a small model's sites."""
    model = tmodel.DeepLabV2(tmodel.DeepLabV2Config(blocks=(1, 1, 1, 1)))
    paths = [p for p, _ in tq.iter_conv_sites(model)]
    return [{p: float(i + 1) for i, p in enumerate(paths)},
            {p: float(len(paths) - i) for i, p in enumerate(paths)}], model


SYNC_CASES = {"both_calibrated": (0, 1), "empty_shard": (0, None), "no_shard_calibrated": (None,
                                                                                          None)}


def _sync_worker(rank: int, work: str, case: str) -> None:
    torch.set_num_threads(1)
    try:
        ddp.init_distributed("gloo", f"file://{work}/rendezvous", 2, rank)
        ranges, model = _site_ranges()
        mine = SYNC_CASES[case][rank]
        try:
            out = tq.sync_amax_across_processes({} if mine is None else ranges[mine], model)
        except ValueError as e:
            out = {"error": str(e)}
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        ddp.shutdown()
    except BaseException:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def test_sync_amax_over_two_gloo_ranks(tmp_path):
    """Two gloo ranks: the ranges take the maximum over the ranks; a rank
    whose shard gave no batch still reaches the collective and takes its
    sibling's; when no rank calibrated, both raise the same error. One
    process: the ranges pass through."""
    assert tq.sync_amax_across_processes({"a": 1.0}) == {"a": 1.0}
    with pytest.raises(ValueError, match="no calibration batches"):
        tq.sync_amax_across_processes({})
    ranges, _ = _site_ranges()
    want = {"both_calibrated": {p: max(v, ranges[1][p]) for p, v in ranges[0].items()},
            "empty_shard": ranges[0],
            "no_shard_calibrated": {"error": "no calibration batches on any process"}}
    ctx = mp.get_context("spawn")
    works, procs = {}, []
    for case in SYNC_CASES:
        works[case] = tmp_path / case
        works[case].mkdir()
        for r in range(2):
            procs.append(ctx.Process(target=_sync_worker, args=(r, str(works[case]), case),
                                     daemon=True))
            procs[-1].start()
    for p in procs:
        p.join(timeout=180)
    for case, work in works.items():
        errors = [f.read_text() for f in work.glob("error_*.txt")]
        assert not errors, errors
        got = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
        assert got == [want[case]] * 2, case
