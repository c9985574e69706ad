"""The port's ``--concat_batches`` slice, ``--profile`` and ``--debug_nans``.

- The canvas helpers (``_valid_sizes``, ``make_canvas_masks``) against the
  JAX package's, exactly.
- The masked canvas forward (no grad: the eval kernel's plain version)
  against JAX's ``apply_deeplabv2(..., masks)`` over the whole canvas, both
  heads, atol 1e-5 (fp32 through ~30 convs in another order; the logits of
  these weights are O(0.1)); its valid slice against the port's forward of
  the unpadded images.
- The concat UDA step against the port's own two-forward step, at the JAX
  package's tolerances for the same comparison (``tests/test_steps.py``:
  metrics rel 1e-4, parameters atol 2e-6). The step against the JAX
  package's concat step is in ``tests/test_torch_steps.py``.
- The entry points on the CPU: ``solve_gta5 --concat_batches true`` and
  ``bench --mode uda --concat``; ``--profile`` writes a trace under
  ``<checkpoint_dir>/profile``; ``--debug_nans`` stops a step whose loss is
  NaN, where the flagless step returns NaN metrics; the kernel wrappers
  refuse a malformed ``valid``; the flags still unported raise, naming
  their ``ROADMAP.md`` item.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxsquareloss_tpu.models import deeplabv2 as jmodel
from maxsquareloss_torch import bench
from maxsquareloss_torch.config import _UNPORTED, TrainConfig, check_supported
from maxsquareloss_torch.convert import state_dict_from_jax
from maxsquareloss_torch.data import synthetic as tsynthetic
from maxsquareloss_torch.data.loader import SegDataLoader
from maxsquareloss_torch.kernels.fused_block import fused_bottleneck, fused_bottleneck_emit
from maxsquareloss_torch.models import deeplabv2 as tmodel
from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.tools import solve_gta5
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train import steps as tsteps
from maxsquareloss_torch.train.uda_trainer import UDATrainer

BLOCKS = (2, 2, 2, 2)
SRC_HW, TGT_HW = (33, 65), (25, 49)  # unequal crops, as the GTA5 protocol
ROADMAP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ROADMAP.md")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised weights at ``BLOCKS`` with randomised BN biases, as
    numpy pytrees."""
    cfg = jmodel.DeepLabV2Config(num_classes=19, multi_level=True, blocks=BLOCKS)
    params, frozen = jmodel.init_deeplabv2(jax.random.key(0), cfg)
    rng = np.random.default_rng(31)
    frozen = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, size=v.shape).astype(np.float32), frozen)
    return jax.tree.map(np.asarray, params), frozen, cfg


def _port_model(params, frozen):
    model = tmodel.DeepLabV2(tmodel.DeepLabV2Config(num_classes=19, blocks=BLOCKS))
    model.load_state_dict(state_dict_from_jax(params, frozen))
    return model.to(memory_format=torch.channels_last).eval()


def _canvas_batch(rng):
    """Two source images at SRC_HW and two target images at TGT_HW, each
    zero-padded at the bottom and right onto the SRC_HW canvas."""
    xs = rng.normal(0, 1, (2, *SRC_HW, 3)).astype(np.float32)
    xt = rng.normal(0, 1, (2, *TGT_HW, 3)).astype(np.float32)
    pad = ((0, 0), (0, SRC_HW[0] - TGT_HW[0]), (0, SRC_HW[1] - TGT_HW[1]), (0, 0))
    return xs, xt, np.concatenate([xs, np.pad(xt, pad)])


# ------------------------------------------------------- canvas helpers ----


@pytest.mark.parametrize("hw", [(33, 65), (25, 49), (640, 1280), (512, 1024), (1, 1), (8, 3)])
def test_valid_sizes_match_jax(hw):
    assert tmodel._valid_sizes(hw) == jmodel._valid_sizes(hw)
    assert tmodel.valid_logits_hw(hw) == tmodel._valid_sizes(hw)["os8"]


CANVAS_CASES = [
    ((33, 65), [(2, (33, 65)), (2, (25, 49))]),
    ((640, 1280), [(4, (640, 1280)), (4, (512, 1024))]),
    ((40, 80), [(1, (32, 64)), (2, (40, 80)), (1, (17, 9))]),
    ((40, 80), [(3, (40, 33))]),
]


@pytest.mark.parametrize("canvas,groups", CANVAS_CASES)
def test_canvas_masks_match_jax(canvas, groups):
    got = tmodel.make_canvas_masks(canvas, groups)
    want = jmodel.make_canvas_masks(canvas, groups)
    assert set(got) == set(want) == {"pool_in", "os4", "os8"}
    n = sum(g for g, _ in groups)
    for key, m in got.items():
        h, w = tmodel._valid_sizes(canvas)[key]
        assert m.mask.shape == (n, 1, h, w) and m.mask.dtype == torch.float32
        assert m.mask.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(m.mask.permute(0, 2, 3, 1).numpy(), np.asarray(want[key]))
        assert m.valid.dtype == torch.int32 and m.valid.is_contiguous()
        assert m.valid.tolist() == [list(tmodel._valid_sizes(hw)[key])
                                    for g, hw in groups for _ in range(g)]


@pytest.mark.parametrize("canvas,groups", [((33, 65), [(2, (33, 65)), (2, (33, 65))]),
                                           ((9, 9), [(1, (9, 9))])])
def test_canvas_masks_none_when_every_group_fills_the_canvas(canvas, groups):
    assert tmodel.make_canvas_masks(canvas, groups) is None
    assert jmodel.make_canvas_masks(canvas, groups) is None


# ------------------------------------------------------ masked forward ----


def test_masked_canvas_forward_matches_jax(weights):
    params, frozen, jcfg = weights
    xs, xt, x = _canvas_batch(np.random.default_rng(32))
    groups = [(2, SRC_HW), (2, TGT_HW)]
    j_aux, j_main = jmodel.apply_deeplabv2(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, frozen), jnp.asarray(x),
        jcfg, jmodel.make_canvas_masks(SRC_HW, groups))
    model = _port_model(params, frozen)
    masks = tmodel.make_canvas_masks(SRC_HW, groups)
    with torch.inference_mode():
        aux, main = model(torch.from_numpy(x), masks=masks)
        # the valid slice is the forward of the unpadded images
        t_aux, t_main = model(torch.from_numpy(xt))
        s_aux, s_main = model(torch.from_numpy(xs))
    assert max(np.abs(j_main).max(), np.abs(j_aux).max()) < 1.0  # atol 1e-5 is ~1e-4 relative
    np.testing.assert_allclose(main.numpy(), np.asarray(j_main), rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(j_aux), rtol=0, atol=1e-5)
    vh, vw = tmodel.valid_logits_hw(TGT_HW)
    for got, unpadded_t, unpadded_s in ((main, t_main, s_main), (aux, t_aux, s_aux)):
        torch.testing.assert_close(got[2:, :vh, :vw], unpadded_t, rtol=0, atol=1e-5)
        torch.testing.assert_close(got[:2], unpadded_s, rtol=0, atol=1e-5)


def test_masked_canvas_forward_with_grad_matches_no_grad(weights):
    """The training forward (FusedBottleneckFn) over the canvas gives the
    eval forward's logits, and the gradient of the target images' valid
    logits reaches their valid pixels as it does through a forward of the
    unpadded images."""
    params, frozen, _ = weights
    _, xt, x = _canvas_batch(np.random.default_rng(33))
    model = _port_model(params, frozen)
    masks = tmodel.make_canvas_masks(SRC_HW, [(2, SRC_HW), (2, TGT_HW)])
    with torch.inference_mode():
        want = model(torch.from_numpy(x), masks=masks)
    xg = torch.from_numpy(x).requires_grad_(True)
    got = model(xg, masks=masks)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    vh, vw = tmodel.valid_logits_hw(TGT_HW)
    cot = torch.from_numpy(np.random.default_rng(34).normal(size=(2, vh, vw, 19)).astype(np.float32))
    (got[1][2:, :vh, :vw] * cot).sum().backward()
    xu = torch.from_numpy(xt).requires_grad_(True)
    (model(xu)[1] * cot).sum().backward()
    torch.testing.assert_close(xg.grad[2:, :TGT_HW[0], :TGT_HW[1]], xu.grad, rtol=1e-4, atol=1e-7)
    assert float(xg.grad[:2].abs().max()) == 0.0  # the source images' logits took no part


@pytest.mark.parametrize("bad,match", [
    (torch.tensor([[5, 7]], dtype=torch.int32), r"\(2, 2\) int32"),
    (torch.tensor([[5, 7], [5, 7]], dtype=torch.int64), r"\(2, 2\) int32"),
    (torch.tensor([[5, 7, 5, 7]], dtype=torch.int32).view(2, 2).t(), "contiguous"),
    (torch.tensor([[5, 7], [0, 7]], dtype=torch.int32), "outside"),
    (torch.tensor([[5, 7], [5, 10]], dtype=torch.int32), "outside"),
])
@pytest.mark.parametrize("kernel", [fused_bottleneck, fused_bottleneck_emit])
def test_kernel_wrappers_refuse_a_malformed_valid(kernel, bad, match):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 5, 9, generator=gen).contiguous(memory_format=torch.channels_last)
    ws = [torch.randn(*s, generator=gen) for s in ((1, 1, 32, 8), (3, 3, 8, 8), (1, 1, 8, 32))]
    bn = [torch.ones(c) for c in (8, 8, 8, 8, 32, 32)]
    with pytest.raises(ValueError, match=match):
        kernel(x, *ws, *bn, 1, bad)


def test_valid_changed_in_place_is_checked_again():
    """The extents are read back once per tensor and version: an in-place
    change is read again."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 5, 9, generator=gen).contiguous(memory_format=torch.channels_last)
    ws = [torch.randn(*s, generator=gen) for s in ((1, 1, 32, 8), (3, 3, 8, 8), (1, 1, 8, 32))]
    bn = [torch.ones(c) for c in (8, 8, 8, 8, 32, 32)]
    valid = torch.tensor([[5, 9], [3, 4]], dtype=torch.int32)
    fused_bottleneck(x, *ws, *bn, 1, valid)
    valid[1, 1] = 10
    with pytest.raises(ValueError, match="outside"):
        fused_bottleneck(x, *ws, *bn, 1, valid)


# ------------------------------------------------------------ the step ----


@pytest.mark.parametrize("tgt_hw", [TGT_HW, SRC_HW], ids=["unequal", "equal"])
def test_concat_step_matches_two_forward_step(weights, tgt_hw):
    params, frozen, _ = weights
    rng = np.random.default_rng(34)
    batch = (torch.from_numpy(rng.normal(0, 1, (2, *SRC_HW, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(-1, 19, (2, *SRC_HW)).astype(np.int32)),
             torch.from_numpy(rng.normal(0, 1, (2, *tgt_hw, 3)).astype(np.float32)))
    runs = {}
    for concat in (False, True):
        cfg = TrainConfig(blocks=BLOCKS, threshold=0.5, iter_max=100, concat_batches=concat)
        model = _port_model(params, frozen)
        _, m = tsteps.make_uda_train_step(cfg)(tsteps.make_train_state(model, cfg), *batch)
        runs[concat] = ({k: v.item() for k, v in m.items()},
                        {n: p.detach() for n, p in model.named_parameters()})
    (ma, pa), (mb, pb) = runs[False], runs[True]
    assert set(ma) == set(mb)
    for k in ma:
        assert mb[k] == pytest.approx(ma[k], rel=1e-4, abs=1e-6), k
    for name in pa:
        np.testing.assert_allclose(pb[name].numpy(), pa[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)


# ------------------------------------------------------ the entry points ----


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("pair"))
    tsynthetic.write_domain_shift_pair(base, n_source=4, n_target_train=4, n_target_val=2,
                                       hw=(32, 64))
    return base


def test_solve_gta5_concat_batches(tmp_path, pair, monkeypatch):
    """solve_gta5 --concat_batches true at unequal crops: every train
    forward is one canvas forward with masks."""
    forwards = []
    forward = tmodel.DeepLabV2.forward

    def recording(self, x, aux=True, masks=None):
        if torch.is_grad_enabled():
            forwards.append((tuple(x.shape), masks is not None))
        return forward(self, x, aux, masks)

    monkeypatch.setattr(tmodel.DeepLabV2, "forward", recording)
    run = str(tmp_path / "run")
    trainer = solve_gta5.main([
        "--data_root_path", pair, "--checkpoint_dir", run, "--device", "cpu",
        "--blocks", "2,2,2,2", "--base_size", "64,32", "--crop_size", "64,32",
        "--target_base_size", "48,24", "--target_crop_size", "48,24", "--batch_size", "2",
        "--num_workers", "2", "--iter_max", "100", "--iter_stop", "2", "--tqdm", "false",
        "--threshold", "0.5", "--concat_batches", "true"])
    assert trainer.cfg.concat_batches and trainer.state.iteration == 2
    assert forwards == [((4, 32, 64, 3), True)] * 2
    assert os.path.exists(os.path.join(run, ckpt_lib.LATEST))
    with open(os.path.join(run, "scalars.jsonl")) as f:
        losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_bench_uda_concat(capsys):
    result = bench.main(["--mode", "uda", "--concat", "--device", "cpu", "--blocks", "2,2,2,2",
                         "--hw", "33,65", "--batch", "2", "--steps", "1", "--warmup", "1",
                         "--with_infer", "false"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert result["extra"]["concat_batches"] is True
    assert result["value"] > 0 and np.isfinite(result["extra"]["final_loss"])


def _uda_trainer(tmp_path, **kw):
    """A UDATrainer at BLOCKS over 8 batch pairs of unequal crops."""
    def loader(hw, seed):
        ds = tsynthetic.SyntheticSegDataset(length=16, hw=hw, seed=seed)
        return SegDataLoader(ds, batch_size=2, shuffle=True, num_workers=2, seed=seed)

    cfg = TrainConfig(blocks=BLOCKS, device="cpu", checkpoint_dir=str(tmp_path), iter_max=100,
                      epoch_num=1, tqdm=False, threshold=0.5, **kw)
    return UDATrainer(cfg, loader((17, 33), 0), loader((13, 25), 1), None)


@pytest.mark.parametrize("iter_stop,trace", [(7, "iterations_2-5"), (4, "iterations_2-3")],
                         ids=["iterations_2_to_5", "run_ends_at_4"])
def test_profile_writes_a_trace_of_iterations_2_to_5(tmp_path, iter_stop, trace):
    trainer = _uda_trainer(tmp_path, profile=True, concat_batches=True, iter_stop=iter_stop)
    trainer.train()
    assert trainer.state.iteration == iter_stop
    assert os.listdir(tmp_path / "profile") == [f"{trace}.pt.trace.json"]
    assert trainer.profiler.path == str(tmp_path / "profile" / f"{trace}.pt.trace.json")
    with open(trainer.profiler.path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names)
    spans = {"msl.step", "msl.forward", "msl.loss", "msl.backward", "msl.block_backward",
             "msl.optimizer", "msl.sync"}
    assert spans <= names
    with open(tmp_path / "train_log.txt") as f:
        logged = [line.split("span ", 1)[1] for line in f if " span msl." in line]
    assert sorted(line.split(":")[0] for line in logged) == sorted(spans)
    per_step = {line.split(":")[0]: line.split(": ")[1].split(" a step")[0] for line in logged}
    assert per_step["msl.step"] == per_step["msl.forward"] == "1"  # one canvas forward
    assert per_step["msl.block_backward"] == "4"
    assert all("device not measured" in line for line in logged)


def test_no_profile_writes_no_trace(tmp_path):
    _uda_trainer(tmp_path, iter_stop=3).train()
    assert not os.path.exists(tmp_path / "profile")


@pytest.mark.parametrize("concat", [False, True], ids=["two_forwards", "concat"])
def test_debug_nans_stops_a_nan_step(weights, concat):
    params, frozen, _ = weights
    rng = np.random.default_rng(35)
    xs = rng.normal(0, 1, (2, *SRC_HW, 3)).astype(np.float32)
    xs[0, 3, 4, 1] = np.nan
    batch = (torch.from_numpy(xs),
             torch.from_numpy(rng.integers(-1, 19, (2, *SRC_HW)).astype(np.int32)),
             torch.from_numpy(rng.normal(0, 1, (2, *TGT_HW, 3)).astype(np.float32)))
    cfg = TrainConfig(blocks=BLOCKS, iter_max=100, concat_batches=concat)
    model = _port_model(params, frozen)
    state = tsteps.make_train_state(model, cfg)
    _, m = tsteps.make_uda_train_step(cfg)(state, *batch)  # no flag: the step runs on
    assert state.iteration == 1 and not np.isfinite(m["loss"].item())
    cfg = dataclasses.replace(cfg, debug_nans=True)
    model = _port_model(params, frozen)
    state = tsteps.make_train_state(model, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(FloatingPointError, match="iteration 0: loss is not finite"):
        tsteps.make_uda_train_step(cfg)(state, *batch)
    assert state.iteration == 0
    assert all(torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())


def test_debug_nans_leaves_a_finite_step_unchanged(weights):
    params, frozen, _ = weights
    rng = np.random.default_rng(36)
    batch = (torch.from_numpy(rng.normal(0, 1, (2, *SRC_HW, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(-1, 19, (2, *SRC_HW)).astype(np.int32)),
             torch.from_numpy(rng.normal(0, 1, (2, *TGT_HW, 3)).astype(np.float32)))
    out = []
    for flag in (False, True):
        cfg = TrainConfig(blocks=BLOCKS, iter_max=100, debug_nans=flag, concat_batches=True)
        model = _port_model(params, frozen)
        _, m = tsteps.make_uda_train_step(cfg)(tsteps.make_train_state(model, cfg), *batch)
        out.append((m["loss"].item(), [p.detach() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert not torch.is_anomaly_enabled()


def _roadmap_queue1_items() -> dict[int, str]:
    with open(ROADMAP) as f:
        text = f.read()
    queue = text.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    items = re.split(r"\n(\d+)\. ", "\n" + queue)
    return {int(items[i]): items[i + 1] for i in range(1, len(items) - 1, 2)}


@pytest.mark.parametrize("name,bad", [("sp", 2)])
def test_still_unported_options_raise_naming_their_roadmap_item(name, bad, monkeypatch):
    """The one option the port lacks is the one the JAX package lacks too
    (``--freeze_bn false``), and it raises saying so; ``--sp`` (its space
    group needs ``bad`` processes) trains with every option, and ROADMAP
    Queue 1's spatial item marks each of its sub-steps done."""
    assert {n for n, _, _ in _UNPORTED} == {"freeze_bn"}
    with pytest.raises(NotImplementedError, match="as in the JAX package"):
        check_supported(TrainConfig(freeze_bn=False))
    monkeypatch.setattr(ddp, "world", lambda: bad)
    check_supported(TrainConfig(**{name: bad}))
    for fields in ({"concat_batches": True}, {"remat": "stages"},
                   {"concat_batches": True, "remat": "stages"}):
        check_supported(TrainConfig(**{name: bad}, **fields))
    item = next(t for t in _roadmap_queue1_items().values() if "Spatial partitioning" in t)
    for sub in "abcd":
        assert f"({sub}) **Done" in " ".join(item.split()), sub


@pytest.mark.parametrize("flags", [["--concat_batches", "true"], ["--profile"], ["--debug_nans"],
                                   ["--compute_dtype", "bfloat16"], ["--remat", "stages"],
                                   ["--quantize", "int8"]])
def test_ported_flags_no_longer_raise(flags, tmp_path):
    import argparse

    from maxsquareloss_torch.config import add_train_args, add_uda_train_args, config_from_args

    p = add_uda_train_args(add_train_args(argparse.ArgumentParser()))
    cfg = config_from_args(p.parse_args(["--checkpoint_dir", str(tmp_path), *flags]))
    check_supported(cfg)
    want = True if flags[1:] in ([], ["true"]) else flags[1]
    assert getattr(cfg, flags[0][2:]) == want
