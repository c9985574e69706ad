"""Spatial partitioning of the port's eval forward (``--sp``) on the CPU:
the port's counterpart of ``tests/test_parallel.py``'s SP tests and
``tests/test_predict.py::test_predict_fn_spatial_partitioned_matches``.

- ownership and window arithmetic (``parallel/spatial.py``), pure Python,
  over heights, sp in {2, 4, 8}, every H-reading op of the model, ceil
  mode and empty shards; each op run on its fetched and padded window
  equals the rows of the op on the whole map;
- ``plan_tiles`` at every halo-extended shard height that sp 2 and sp 4
  give the identity blocks at the protocol's sizes;
- gloo ranks (worlds 2 and 4, started once per module): ``fetch_rows`` and
  ``fetch_window`` against slicing the whole tensor (windows that span two
  ranks, pass the border, gather to one rank, empty shards; fp32, bf16,
  int32); the SP eval step at sp 2, sp 4 and dp2 x sp2, fp32 and bf16, with
  ``eval_h_chunk`` 24 (not a divisor of a shard), against the port's
  one-process step and the JAX package's one-device ``make_eval_step``; a
  map with empty shards; SP predict at sp 4, scales 0.75,1.0 + flip,
  against the JAX ``make_predict_fn``;
- the training form of the heads under ``--sp`` (a model built for
  training, run without grad);
- the config checks of ``--sp``.

Tolerances. Against the port's one-process step: fp32 logits within 1e-5
of the largest |logit| (read: the main head 0, the same ops on the same
rows; the aux head and the empty-shards case 4.1e-7 and 3.5e-7, the
layer3 output's convs on fewer rows); bf16 logits within 1e-3 of it (a bf16 GEMM on the CPU rounds a row
differently with the number of rows it is given: the heads' tap product
over a shard's rows moves a product by 1-4 bf16 ulps, and the logits by
up to 1.8e-4 of the largest, five times under the limit); argmax agreement
>= 99.9 %, mIoU within 1e-4. Against JAX: the port's
eval limits (PERF.md section 2): fp32 as ``tests/test_torch_eval.py``
(the argmax wherever the top-two gap exceeds 1e-3, the confusion matrix
over those pixels exactly, mIoU within 1e-3); bf16 as
``tests/test_torch_bf16.py`` (logits within 1.35e-2 of the largest,
argmax agreement >= 98.7 %).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.kernels import fused_block
from maxsquareloss_torch.metrics import Eval
from maxsquareloss_torch.models.deeplabv2 import _valid_sizes
from maxsquareloss_torch.parallel import ddp, spatial

sys.path.insert(0, ".")

BLOCKS = (1, 1, 2, 1)  # tests/test_parallel.py's SMALL
IMG_HW, LABEL_HW, BATCH = (64, 64), (128, 128), 4  # tests/test_parallel.py's sizes
H_CHUNK = 24  # not a divisor of 128, nor of a shard
SMALL_HW = (17, 33)  # os8 maps of 3 rows: at sp 4 one rank owns none
PREDICT_HW, PREDICT_OUT = (32, 64), (64, 128)  # tests/test_predict.py's
PREDICT_SCALES = (0.75, 1.0)
GAP = 1e-3
# max |logit difference| over the largest |logit| against the one-process step
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# name: (world, sp, compute dtype, scales, flip, input size, the heads' form
# of the model: the eval form, or the training form, which the forward
# then runs and the eval step turns into the eval form)
CASES = {
    "sp2_fp32": (2, 2, "float32", (1.0,), False, IMG_HW, "eval"),
    "sp2_bf16": (2, 2, "bfloat16", (1.0,), False, IMG_HW, "eval"),
    "sp4_fp32": (4, 4, "float32", (1.0,), False, IMG_HW, "eval"),
    "sp4_bf16": (4, 4, "bfloat16", (1.0,), False, IMG_HW, "eval"),
    "dp2xsp2_fp32": (4, 2, "float32", (1.0,), False, IMG_HW, "eval"),
    "dp2xsp2_bf16": (4, 2, "bfloat16", (1.0,), False, IMG_HW, "eval"),
    "sp4_fp32_tta": (4, 4, "float32", PREDICT_SCALES, True, IMG_HW, "eval"),
    "sp4_fp32_empty_shards": (4, 4, "float32", (1.0,), False, SMALL_HW, "eval"),
    "sp4_fp32_train_heads": (4, 4, "float32", (1.0,), False, IMG_HW, "train"),
}
JAX_CASES = [c for c in CASES if CASES[c][3] == (1.0,) and CASES[c][5] == IMG_HW
             and CASES[c][6] == "eval"]
WORLDS = (2, 4)

# -- ownership and windows ----------------------------------------------------

HEIGHTS = (1, 3, 9, 17, 33, 65, 129, 257)
# the model's H-reading ops: (name, k, s, p, d, ceil mode)
OPS = [("stem", 7, 2, 3, 1, False), ("pool", 3, 2, 1, 1, True),
       ("conv1_stride2", 1, 2, 0, 1, False), ("conv1x1", 1, 1, 0, 1, False),
       *[(f"conv2_d{d}", 3, 1, d, d, False) for d in (1, 2, 4)],
       *[(f"aspp_d{d}", 3, 1, d, d, False) for d in (6, 12, 18, 24)]]


def _out_h(h, k, s, p, d, ceil):
    if ceil:
        return math.ceil((h + 2 * p - d * (k - 1) - 1) / s) + 1
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("h", HEIGHTS)
def test_split_covers_every_row_once(h, sp):
    parts = spatial.split(h, sp)
    assert parts[0][0] == 0 and parts[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    sizes = [b - a for a, b in parts]
    assert max(sizes) - min(sizes) <= 1
    assert sum(s == 0 for s in sizes) == max(0, sp - h)  # empty shards only below sp rows


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("op", OPS, ids=[o[0] for o in OPS])
def test_window_is_the_rows_each_output_row_reads(op, sp):
    _, k, s, p, d, ceil = op
    for h_in in (9, 17, 65, 129):
        h_out = _out_h(h_in, k, s, p, d, ceil)
        for own in spatial.split(h_out, sp):
            reads = [o * s - p + i * d for o in range(*own) for i in range(k)]
            want = (min(reads), max(reads) + 1) if reads else (0, 0)
            assert spatial.window(own, k, s, p, d) == want
            a, b = spatial.window(own, k, s, p, d)
            if own[1] > own[0]:  # the window, run with H padding 0, gives exactly own rows
                assert _out_h(b - a, k, s, 0, d, ceil) == own[1] - own[0]


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("op", OPS, ids=[o[0] for o in OPS])
def test_op_on_its_padded_window_equals_its_rows(op, sp):
    """Every op on the window of each rank's rows, taken from the whole map
    and padded where it passes the border (zeros; -inf for the pool), with
    H padding 0, gives that rank's rows of the op on the whole map."""
    name, k, s, p, d, ceil = op
    gen = torch.Generator().manual_seed(k * 100 + d)
    for h_in in (9, 17, 30):
        x = torch.randn(2, 3, h_in, 11, generator=gen)
        if name == "pool":
            full = F.max_pool2d(x, k, s, p, ceil_mode=True)
        else:
            wt = torch.randn(4, 3, k, k, generator=gen)
            full = F.conv2d(x, wt, stride=s, padding=p, dilation=d)
        h_out = full.shape[2]
        assert h_out == _out_h(h_in, k, s, p, d, ceil)
        for own in spatial.split(h_out, sp):
            a, b = spatial.window(own, k, s, p, d)
            if own[1] <= own[0]:
                continue
            c0, c1 = spatial.clip((a, b), h_in)
            pad = -math.inf if name == "pool" else 0.0
            win = F.pad(x[:, :, c0:c1], (0, 0, c0 - a, b - c1), value=pad)
            if name == "pool":
                got = F.max_pool2d(win, k, s, (0, p), ceil_mode=True)
            else:
                got = F.conv2d(win, wt, stride=s, padding=(0, p), dilation=d)
            torch.testing.assert_close(got, full[:, :, own[0]:own[1]], rtol=0, atol=1e-5)


def test_empty_rows_have_an_empty_window_and_clip():
    assert spatial.window((3, 3), 7, 2, 3, 1) == (0, 0)
    assert spatial.clip((-3, 2), 10) == (0, 2) and spatial.clip((8, 14), 10) == (8, 10)
    assert spatial.clip((12, 14), 10) == (12, 12)


# -- the planner at shard heights ---------------------------------------------

def _shard_heights(img_hw, sp):
    """{(map height h of the window, W, Cin, Cmid, d)} of every identity
    block's launch on every rank at ``img_hw`` under ``sp``: its rows plus
    d on each side, clipped to the map."""
    sizes = _valid_sizes(img_hw)
    out = set()
    for layer, (cmid, d) in enumerate(zip((64, 128, 256, 512), (1, 1, 2, 4))):
        h, w = sizes["os4" if layer == 0 else "os8"]
        for o0, o1 in spatial.split(h, sp):
            a, b = spatial.clip((o0 - d, o1 + d), h)
            out.add((b - a, w, 4 * cmid, cmid, d))
    return sorted(out)


PLAN_CASES = [(hw, sp) for hw in ((512, 1024), (384, 768), (1024, 2048), (768, 1536),
                                  (640, 1280)) for sp in (2, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,sp", PLAN_CASES, ids=[f"{h}x{w}_sp{sp}" for (h, w), sp in PLAN_CASES])
def test_plan_tiles_at_shard_heights(hw, sp, dtype):
    """The planner at every shard height of the protocol's sizes (1024x512
    and predict's 0.75 scale of it, the 2048x1024 serving input and its 0.75
    scale, and the training crops 1280x640 and 1024x512, whose identity
    blocks run the emit kernel: one plan serves both, bf16 on the tc route)
    at the batches of a rank (1, 2, and the training batch 4): the
    whole-map plan's tile (it depends on W, the widths and d, not on H),
    shared memory within a block's, and chains whose segments cover every
    row of the shard once (the kernel skips a block whose segment starts
    past the last row)."""
    for h, w, cin, cmid, d in _shard_heights(hw, sp):
        for n in (1, 2, 4):
            plan = fused_block.plan_tiles(n, h, w, cin, cmid, d, 132, dtype)
            whole = fused_block.plan_tiles(n, _valid_sizes(hw)["os8"][0], w, cin, cmid, d, 132,
                                           dtype)
            assert plan.tw == whole.tw and plan.smem == whole.smem and plan.threads == whole.threads
            assert plan.smem <= fused_block.SMEM_BLOCK_MAX
            chain = math.ceil(h / d)
            assert plan.rs * plan.segs >= chain > plan.rs * (plan.segs - 1)
            assert plan.tw * math.ceil(w / plan.tw) >= w
            if dtype == torch.bfloat16:  # conv1 and conv3 on wgmma at every shard height
                assert plan.conv_routes() == {"conv1": "wgmma", "conv2": "fma", "conv3": "wgmma"}


# -- gloo ranks ---------------------------------------------------------------

def _fetch_cases():
    """(name, sp, height, dtype, rank dims, needs(sp, own) → every rank's
    request, pad value or None)."""
    def halo(k):
        return lambda sp, own: [(a - k, b + k) if b > a else (0, 0) for a, b in own]

    cases = []
    for sp in (2, 4):
        cases += [
            (f"halo1_sp{sp}", sp, 10, torch.float32, 4, halo(1), None),
            (f"two_ranks_away_sp{sp}", sp, 10, torch.float32, 4, halo(5), None),
            (f"padded_sp{sp}", sp, 10, torch.float32, 4, halo(3), 0.0),
            (f"padded_neg_inf_sp{sp}", sp, 9, torch.bfloat16, 4, halo(2), -math.inf),
            (f"bf16_sp{sp}", sp, 13, torch.bfloat16, 4, halo(2), None),
            (f"labels_int32_sp{sp}", sp, 11, torch.int32, 3, halo(1), None),
            (f"gather_sp{sp}", sp, 10, torch.float32, 4,
             lambda sp, own: [(0, own[-1][1]) if s == 0 else (0, 0) for s in range(sp)], None),
            (f"empty_shards_sp{sp}", sp, 3, torch.float32, 4, halo(1), 0.0),
        ]
    return cases


FETCH_CASES = _fetch_cases()


def _fetch_full(index, h, dtype, dims):
    gen = torch.Generator().manual_seed(index)
    shape = (2, h, 5, 3)[:dims]
    if dtype == torch.int32:
        return torch.randint(-1, 19, shape, generator=gen, dtype=torch.int32)
    return torch.randn(shape, generator=gen).to(dtype)


def _fetch_expected(full, need, h, pad):
    a, b = need
    c0, c1 = spatial.clip((a, b), h)
    rows = full[:, c0:c1]
    if pad is None or b <= a:
        return rows
    return F.pad(rows, (0, 0) * (full.dim() - 2) + (c0 - a, b - c1), value=pad)


def _run_fetch_cases(world):
    out = {}
    for index, (name, sp, h, dtype, dims, needs, pad) in enumerate(FETCH_CASES):
        if world % sp:
            continue
        space = spatial.space_group(sp)
        full = _fetch_full(index, h, dtype, dims)
        own = space.split(h)
        need = needs(sp, own)
        mine = full[:, own[space.index][0]:own[space.index][1]].contiguous()
        if pad is None:
            got = spatial.fetch_rows(mine, own, need, space)
        else:
            got = spatial.fetch_window(mine, h, need, space, pad)
        want = _fetch_expected(full, need[space.index], h, pad)
        ok = got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
        out[name] = bool(ddp.all_gather(torch.tensor(int(ok))).min())
    return out


def _inputs(img_hw, batch=BATCH, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(batch, *img_hw, 3)).astype(np.uint8)
    label_hw = LABEL_HW if img_hw == IMG_HW else img_hw
    y = np.random.default_rng(seed + 1).integers(-1, 19, size=(batch, *label_hw)).astype(np.int32)
    return x, y


def _port_model(state_dict, dtype, heads="eval"):
    from maxsquareloss_torch.models.deeplabv2 import DeepLabV2
    from maxsquareloss_torch.train.steps import model_config

    cfg = TrainConfig(blocks=BLOCKS, compute_dtype=dtype, eval_h_chunk=H_CHUNK)
    model = DeepLabV2(model_config(cfg, eval_mode=heads == "eval"))
    model.load_state_dict(state_dict)
    return cfg, model.to(memory_format=torch.channels_last).eval()


def _run_sp_case(case, state_dict, work):
    """This rank's share of ``case``: its data group's images, its rows of
    them; saves its logit rows, argmax rows and confusion matrix."""
    from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step
    from maxsquareloss_torch.train.steps import _prepare_inputs

    world, sp, dtype, scales, flip, img_hw, heads = CASES[case]
    cfg, model = _port_model(state_dict, dtype, heads)
    space = spatial.space_group(sp)
    group, groups = spatial.data_groups(sp)
    x, y = _inputs(img_hw)
    per = BATCH // groups
    x, y = x[group * per:(group + 1) * per], y[group * per:(group + 1) * per]
    (a, b), (c, d) = space.own(x.shape[1]), space.own(y.shape[1])
    xs, ys = torch.from_numpy(x[:, a:b].copy()), torch.from_numpy(y[:, c:d].copy())
    with torch.inference_mode():
        aux, main = model(_prepare_inputs(xs, None, cfg)[0], space=space, in_h=x.shape[1])
    step = make_multiscale_eval_step(cfg, model, scales, flip, space=space)
    cm, arg = step(xs, ys, (x.shape[1], y.shape[1]))
    cm_all = ddp.all_reduce_sum(cm)
    np.savez(os.path.join(work, f"{case}_rank{ddp.rank()}.npz"), main=main.numpy(),
             aux=aux.numpy(), arg=arg.numpy(), cm=cm_all.numpy(), group=group,
             index=space.index)


def _run_sp_predict(state_dict, work):
    from maxsquareloss_torch.predict import make_predict_fn

    cfg, model = _port_model(state_dict, "float32")
    space = spatial.space_group(4)
    x = np.random.default_rng(6).standard_normal((1, *PREDICT_HW, 3)).astype(np.float32)
    a, b = space.own(PREDICT_HW[0])
    fn = make_predict_fn(cfg, model, PREDICT_SCALES, True, PREDICT_OUT, space)
    rows = fn(torch.from_numpy(x[:, a:b].copy()), PREDICT_HW[0])
    full = spatial.gather_rows(rows, PREDICT_OUT[0], space)
    if ddp.rank() == 0:
        np.save(os.path.join(work, "predict.npy"), full.numpy())


def _worker(rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    try:
        ddp.init_distributed("gloo", f"file://{work}/rendezvous", world, rank)
        state_dict = torch.load(os.path.join(work, "weights.pt"))
        fetched = _run_fetch_cases(world)
        for case, (w, *_rest) in CASES.items():
            if w == world:
                _run_sp_case(case, state_dict, work)
        if world == 4:
            _run_sp_predict(state_dict, work)
        if rank == 0:
            torch.save(fetched, os.path.join(work, "fetch.pt"))
        ddp.shutdown()
    except Exception:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def weights():
    """The JAX package's weights (key 0, as tests/test_parallel.py) and
    their port state dict."""
    import jax

    from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
    from maxsquareloss_tpu.models.deeplabv2 import init_deeplabv2 as jinit
    from maxsquareloss_tpu.train.steps import model_config as jmodel_config
    from maxsquareloss_torch.convert import state_dict_from_jax

    params, frozen = jinit(jax.random.key(0), jmodel_config(JTrainConfig(blocks=BLOCKS,
                                                                         data_parallel=False)))
    params, frozen = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, frozen)
    return params, frozen, state_dict_from_jax(params, frozen)


def _jax_references(params, frozen):
    """The JAX one-device eval step (fp32 and bf16, h_chunk 24) on the whole
    batch, its bf16 eval-path logits, and its predict function."""
    import jax
    import jax.numpy as jnp

    from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
    from maxsquareloss_tpu.models import deeplabv2 as jmodel
    from maxsquareloss_tpu.train.evaluator import make_multiscale_eval_step as jmake_step
    from maxsquareloss_tpu.train.steps import _prepare_inputs as jprepare
    from tools.predict import make_predict_fn as jmake_predict_fn

    x, y = _inputs(IMG_HW)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = JTrainConfig(blocks=BLOCKS, data_parallel=False, eval_h_chunk=H_CHUNK,
                            compute_dtype=dtype)
        cm, arg = jmake_step(jcfg, frozen)(params, jnp.asarray(x), jnp.asarray(y))
        out[dtype] = (np.asarray(cm), np.asarray(arg))
    jcfg = JTrainConfig(blocks=BLOCKS, data_parallel=False)
    xn, _ = jprepare(jnp.asarray(x), None, jcfg)
    mcfg = jmodel.DeepLabV2Config(num_classes=19, blocks=BLOCKS, compute_dtype=jnp.bfloat16,
                                  aspp_matmul=True)
    out["bf16_logits"] = np.asarray(jmodel.apply_deeplabv2(params, frozen, xn, mcfg)[1])
    xp = np.random.default_rng(6).standard_normal((1, *PREDICT_HW, 3)).astype(np.float32)
    out["predict"] = np.asarray(jax.jit(jmake_predict_fn(jcfg, frozen, PREDICT_SCALES, True,
                                                         PREDICT_OUT))(params, jnp.asarray(xp)))
    return out


def _port_references(state_dict):
    """The port's one-process step and forward on the whole batch, per case."""
    from maxsquareloss_torch.predict import make_predict_fn
    from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step
    from maxsquareloss_torch.train.steps import _prepare_inputs

    out = {}
    for case, (_, _, dtype, scales, flip, img_hw, heads) in CASES.items():
        cfg, model = _port_model(state_dict, dtype, heads)
        x, y = _inputs(img_hw)
        with torch.inference_mode():
            aux, main = model(_prepare_inputs(torch.from_numpy(x), None, cfg)[0])
        cm, arg = make_multiscale_eval_step(cfg, model, scales, flip)(torch.from_numpy(x),
                                                                       torch.from_numpy(y))
        out[case] = {"main": main.numpy(), "aux": aux.numpy(), "cm": cm.numpy(),
                     "arg": arg.numpy(), "y": y}
    cfg, model = _port_model(state_dict, "float32")
    xp = np.random.default_rng(6).standard_normal((1, *PREDICT_HW, 3)).astype(np.float32)
    out["predict"] = make_predict_fn(cfg, model, PREDICT_SCALES, True, PREDICT_OUT)(
        torch.from_numpy(xp)).numpy()
    out["predict_x"] = xp
    return out


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory, weights):
    """Both worlds' groups, started together; meanwhile, in this process,
    the references. (work directory by world, the port's references, the
    JAX package's)."""
    ctx = mp.get_context("spawn")
    procs, works = [], {}
    for world in WORLDS:
        work = str(tmp_path_factory.mktemp(f"sp_world{world}"))
        torch.save(weights[2], os.path.join(work, "weights.pt"))
        works[world] = work
        for rank in range(world):
            p = ctx.Process(target=_worker, args=(rank, world, work), daemon=True)
            p.start()
            procs.append(p)
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        port = _port_references(weights[2])
        jax_ref = _jax_references(*weights[:2])
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    for world, work in works.items():
        errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
                  if f.startswith("error_")]
        assert not errors, f"world {world}:\n" + "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return works, port, jax_ref


def _assembled(works, case):
    """The ranks' rows put back together: (main logits, aux logits, argmax)
    over the whole batch, and the world-summed confusion matrix."""
    world, sp = CASES[case][:2]
    ranks = [np.load(os.path.join(works[world], f"{case}_rank{r}.npz")) for r in range(world)]
    groups = world // sp
    out = {}
    for key in ("main", "aux", "arg"):
        per_group = [np.concatenate([ranks[g * sp + s][key] for s in range(sp)], axis=1)
                     for g in range(groups)]
        out[key] = np.concatenate(per_group, axis=0)
    for r in ranks:
        np.testing.assert_array_equal(r["cm"], ranks[0]["cm"])
    out["cm"] = ranks[0]["cm"]
    return out


def _miou(cm):
    ev = Eval(19)
    ev.add_confusion_matrix(torch.as_tensor(cm))
    return ev.Mean_Intersection_over_Union()


@pytest.mark.parametrize("case", list(CASES))
def test_sp_eval_step_matches_the_one_process_step(sp_runs, case):
    works, port, _ = sp_runs
    got, want = _assembled(works, case), port[case]
    for key in ("main", "aux"):
        scale = float(np.abs(want[key]).max())
        diff = float(np.abs(got[key] - want[key]).max())
        print(f"{case} {key}: max |diff| {diff:.3g} of max |logit| {scale:.3g}")
        assert got[key].shape == want[key].shape
        assert diff <= LOGIT_TOL[CASES[case][2]] * scale, (key, diff, scale)
    assert float((got["arg"] == want["arg"]).mean()) >= 0.999
    assert int(got["cm"].sum()) == int((want["y"] >= 0).sum())
    assert abs(_miou(got["cm"]) - _miou(want["cm"])) <= 1e-4


def test_sp_shards_can_be_empty(sp_runs):
    """At SMALL_HW the os8 maps have 3 rows: at sp 4 rank 0 owns none of
    them, launches nothing for them, and still serves its neighbours."""
    works = sp_runs[0]
    r0 = np.load(os.path.join(works[4], "sp4_fp32_empty_shards_rank0.npz"))
    assert r0["main"].shape[1] == 0 and spatial.rows(3, 4, 0) == (0, 0)
    assert r0["arg"].shape[1] == SMALL_HW[0] // 4


def _confident(logits_or_prob, gap=GAP):
    top2 = -np.sort(-logits_or_prob, axis=-1)[..., :2]
    return (top2[..., 0] - top2[..., 1]) > gap


@pytest.mark.parametrize("case", JAX_CASES)
def test_sp_eval_step_matches_jax(sp_runs, case):
    from maxsquareloss_torch.ops.resize import resize_bilinear_align_corners

    works, port, jax_ref = sp_runs
    dtype = CASES[case][2]
    got = _assembled(works, case)
    jcm, jarg = jax_ref[dtype]
    y = port[case]["y"]
    if dtype == "float32":
        # the argmax wherever the port's top-two gap exceeds 1e-3, the matrix
        # over those pixels exactly, mIoU within 1e-3
        up = resize_bilinear_align_corners(torch.from_numpy(port[case]["main"]), LABEL_HW)
        confident = _confident(up.numpy())
        assert confident.mean() > 0.9
        np.testing.assert_array_equal(got["arg"][confident], jarg[confident])
        y_conf = np.where(confident, y, -1)
        ev_got, ev_jax = Eval(19), Eval(19)
        ev_got.add_batch(y_conf, got["arg"])
        ev_jax.add_batch(y_conf, jarg)
        np.testing.assert_array_equal(ev_got.confusion_matrix, ev_jax.confusion_matrix)
        assert abs(_miou(got["cm"]) - _miou(jcm)) <= 1e-3
    else:
        assert float((got["arg"] == jarg).mean()) >= 0.987
        want = jax_ref["bf16_logits"]
        scale = float(np.abs(want).max())
        assert float(np.abs(got["main"] - want).max()) <= 1.35e-2 * scale
        assert float((got["main"].argmax(-1) == want.argmax(-1)).mean()) >= 0.987


def test_sp_predict_matches_jax_and_one_process(sp_runs, weights):
    """predict --sp 4 at 0.75,1.0 + flip, gathered on rank 0: equal to the
    port's one-process function on >= 99.9 % of the pixels, and to the JAX
    ``make_predict_fn`` wherever the port's top-two gap exceeds 1e-3."""
    from maxsquareloss_torch.train.evaluator import tta_prob_rows

    works, port, jax_ref = sp_runs
    got = np.load(os.path.join(works[4], "predict.npy"))
    assert got.shape == (1, *PREDICT_OUT) and got.dtype == np.int32
    assert float((got == port["predict"]).mean()) >= 0.999
    cfg, model = _port_model(weights[2], "float32")
    with torch.inference_mode():
        prob = tta_prob_rows(model, torch.from_numpy(port["predict_x"]), PREDICT_SCALES, True,
                             PREDICT_OUT)(0, PREDICT_OUT[0]).numpy()
    confident = _confident(prob)
    assert confident.mean() > 0.9
    np.testing.assert_array_equal(got[confident], jax_ref["predict"][confident])


FETCH_PARAMS = [(c[0], world) for c in FETCH_CASES for world in WORLDS if world % c[1] == 0]


@pytest.mark.parametrize("name,world", FETCH_PARAMS, ids=[f"{n}_world{w}" for n, w in FETCH_PARAMS])
def test_fetch_rows_matches_slicing(sp_runs, name, world):
    """Every fetch case at every world its sp divides (sp 2 at worlds 2
    and 4, as dp2 x sp2 at 4; sp 4 at world 4): every rank's rows equal
    the slice of the whole tensor, bitwise."""
    assert torch.load(os.path.join(sp_runs[0][world], "fetch.pt"))[name]


# -- the config checks ----------------------------------------------------------

def _argv(tmp_path, *extra):
    return ["--checkpoint_dir", str(tmp_path), *extra]


def _parse(argv):
    import argparse

    from maxsquareloss_torch.config import add_train_args

    return add_train_args(argparse.ArgumentParser()).parse_args(argv)


@pytest.mark.parametrize("flags,error,match", [
    (["--sp", "4", "--crop_size", "64,30"], ValueError, "must divide the image height"),
    (["--sp", "4", "--base_size", "64,30"], ValueError, "must divide the image height"),
    (["--sp", "2", "--quantize", "int8"], ValueError, "does not compose with --sp"),
    (["--sp", "2"], ValueError, "does not divide the 1 process"),
    (["--sp", "0"], ValueError, "--sp must be >= 1"),
], ids=["crop_h", "base_h", "int8", "world", "zero"])
def test_serving_config_checks(tmp_path, flags, error, match):
    from maxsquareloss_torch.config import config_from_args

    with pytest.raises(error, match=match):
        config_from_args(_parse(_argv(tmp_path, "--crop_size", "64,32", "--base_size", "64,32",
                                      *flags)))


def test_serving_config_takes_sp_under_its_world(tmp_path, monkeypatch):
    from maxsquareloss_torch.config import check_supported, config_from_args

    sizes = ["--crop_size", "64,32", "--base_size", "64,32"]
    monkeypatch.setenv("WORLD_SIZE", "4")
    cfg = config_from_args(_parse(_argv(tmp_path, *sizes, "--sp", "2")))
    assert cfg.sp == 2
    monkeypatch.setattr(ddp, "world", lambda: 4)
    check_supported(cfg)  # dp2 x sp2
    # --data_parallel false is one space group: sp = world
    check_supported(TrainConfig(sp=4, data_parallel=False))
    with pytest.raises(ValueError, match="unrelated models"):
        check_supported(TrainConfig(sp=2, data_parallel=False))
    # the trainers' check takes it too, with every training option
    check_supported(cfg)
    for fields in ({"concat_batches": True}, {"remat": "stages"},
                   {"concat_batches": True, "remat": "stages"}):
        check_supported(dataclasses.replace(cfg, **fields))


def test_space_groups_need_sp_to_divide_the_world(monkeypatch):
    assert spatial.space_group(1) is None
    monkeypatch.setattr(ddp, "world", lambda: 3)
    monkeypatch.setattr(spatial, "_groups", {})
    with pytest.raises(ValueError, match="does not divide the 3"):
        spatial.space_group(2)
    monkeypatch.setattr(ddp, "rank", lambda: 5)
    monkeypatch.setattr(ddp, "world", lambda: 8)
    assert spatial.data_groups(4) == (1, 2) and spatial.data_groups(1) == (5, 8)
    assert ddp.local_batch(8, sp=4) == 4
    with pytest.raises(ValueError, match="data groups of --sp 4"):
        ddp.local_batch(3, sp=4)
