"""Training under spatial partitioning (``--sp``) on the CPU: the port's
counterpart of ``tests/test_parallel.py::
test_spatial_partitioned_uda_step_equals_single_device``.

Gloo ranks (worlds 2 and 4, started once per module, one torch thread
each), meanwhile the references in this process:

- **the exchange's backward** (``spatial.fetch_rows`` / ``fetch_window``
  under grad) against the gradient through plain slicing of the whole map:
  windows one and several ranks away, requests that overlap (every rank
  asking for every row), an empty shard, zero and -inf padding (the
  ceil-mode pool's max), windows inside a rank's own rows, float64 and
  bfloat16 (gloo moves it as int16 both ways);
- **the SP train step** against the port's one-process step on the global
  batch, two steps from the JAX package's weights (heads scaled up so that
  the guidance threshold passes on some pixels, BN randomised): the UDA
  step with ``IW_maxsquare`` in fp32 at sp 2, sp 4 and dp2 x sp2, each
  other target mode and the supervised step at sp 2, and bf16 at sp 2.
  The target crop's os8 maps have 3 rows, so at sp 4 a rank owns none of
  them; every parameter still gets a gradient on every rank, and every
  rank holds the same parameters after each step;
- ``Trainer --sp 2``: lockstep preemption (a SIGTERM on one rank stops
  both at the same boundary, one checkpoint) and a resume that continues
  the uninterrupted run's losses exactly;
- the sp 2 step against the JAX package's one-device ``make_uda_train_step``
  on the global batch (``tests/test_torch_steps.py``'s bounds);
- the config checks of ``--sp`` for the trainers.

Tolerances. Against the port's one-process step: fp32 metrics rel 1e-5,
parameters 2e-6 absolute (the JAX test's bound) and, stronger, each
parameter's change after step 1 within 1e-4 relative L2 (the DDP tests'
bound); read: metrics 6.3e-7 (``entropy``'s ``loss_target``), changes
6.1e-5 relative L2 (sp 4; 2.1-3.6e-5 at sp 2 and dp2 x sp2), parameters
6.0e-8 absolute. bf16 against the one-process bf16 step:
``BF16_STEP_RTOL`` and ``BF16_PARAM_RTOL_L2``, twice the readings
(``PERF.md`` section 2). Against JAX: metrics rtol 5e-4, parameter changes
1e-3 relative L2 (read 5.9e-7 and 6.3e-5).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.parallel import ddp, spatial

BLOCKS = (2, 2, 2, 2)  # an identity block in every layer: d 1, 1, 2, 4
# heights that sp 2 and sp 4 divide; the target's os8 maps have 3 rows, so
# at sp 4 rank 0 owns none of them
SRC_HW, TGT_HW = (24, 48), (16, 32)
GLOBAL_BATCH = 2
STEPS = 2
HEAD_SCALE = 40.0
# name: (world, sp, UDA step?, config fields)
IW = {"target_mode": "IW_maxsquare"}
CASES = {
    "sp2_iw_fp32": (2, 2, True, IW),
    "sp2_maxsquare": (2, 2, True, {"target_mode": "maxsquare"}),
    "sp2_entropy": (2, 2, True, {"target_mode": "entropy"}),
    "sp2_iw_entropy": (2, 2, True, {"target_mode": "IW_entropy"}),
    "sp2_hard": (2, 2, True, {"target_mode": "hard"}),
    "sp2_supervised": (2, 2, False, {}),
    "sp2_iw_bf16": (2, 2, True, {**IW, "compute_dtype": "bfloat16"}),
    "sp4_iw_fp32": (4, 4, True, IW),
    "dp2xsp2_iw_fp32": (4, 2, True, IW),
}
# bf16 against the one-process bf16 step: a shard's bf16 convs round some
# values the other way (a CPU bf16 GEMM rounds by the rows it is given), and
# the guidance threshold and the IW argmax carry it; twice the readings
# (PERF.md section 2): second-step loss_target 5.3e-3, changes 6.95e-3
BF16_STEP_RTOL, BF16_PARAM_RTOL_L2 = 1.1e-2, 1.4e-2
WORLDS = (2, 4)


def _cfg(case: str, **kw) -> TrainConfig:
    world, sp, _, fields = CASES[case]
    return TrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5, device="cpu", **fields, **kw)


def _batches():
    """``STEPS`` global batches of numpy (xs, ys, xt)."""
    rng = np.random.default_rng(22)
    return [(rng.normal(0, 1, (GLOBAL_BATCH, *SRC_HW, 3)).astype(np.float32),
             rng.integers(-1, 19, (GLOBAL_BATCH, *SRC_HW)).astype(np.int32),
             rng.normal(0, 1, (GLOBAL_BATCH, *TGT_HW, 3)).astype(np.float32))
            for _ in range(STEPS)]


def _port_model(state_dict, cfg: TrainConfig):
    from maxsquareloss_torch.models.deeplabv2 import DeepLabV2
    from maxsquareloss_torch.train.steps import model_config

    model = DeepLabV2(model_config(cfg))
    model.load_state_dict(state_dict)
    return model.to(memory_format=torch.channels_last)


def _run_steps(case: str, state_dict, sp: int = 1, images=slice(None)):
    """``STEPS`` steps of the port on ``images`` of each global batch, under
    ``--sp sp``: (metrics a step, parameters after step 1, the model)."""
    from maxsquareloss_torch.train import steps as tsteps

    uda = CASES[case][2]
    cfg = _cfg(case, sp=sp)
    model = _port_model(state_dict, cfg)
    state = tsteps.make_train_state(model, cfg)
    step = (tsteps.make_uda_train_step if uda else tsteps.make_supervised_train_step)(cfg)
    metrics, after_1 = [], None
    for xs, ys, xt in _batches():
        args = (xs[images], ys[images]) + ((xt[images],) if uda else ())
        state, m = step(state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
        metrics.append({k: v.item() for k, v in m.items()})
        if after_1 is None:
            after_1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    return metrics, after_1, model


# -- the exchange's backward ---------------------------------------------------

def _halo(k):
    return lambda sp, own: [(a - k, b + k) if b > a else (0, 0) for a, b in own]


def _everything(sp, own):
    return [(0, own[-1][1])] * sp


def _pool_windows(sp, own):
    """The windows of the ceil-mode 3x3/2 p1 pool's output rows."""
    h_out = math.ceil((own[-1][1] + 2 - 3) / 2) + 1
    return [spatial.window(o, 3, 2, 1) for o in spatial.split(h_out, sp)]


# (name, sp, height, dtype, needs(sp, own) → every rank's request, pad or
# None, pooled: the ceil-mode 3x3/2 pool over the window)
GRAD_CASES = []
for _sp in (2, 4):
    GRAD_CASES += [
        (f"halo1_sp{_sp}", _sp, 10, torch.float64, _halo(1), 0.0, False),
        (f"several_ranks_away_sp{_sp}", _sp, 10, torch.float64, _halo(5), 0.0, False),
        (f"every_rank_every_row_sp{_sp}", _sp, 9, torch.float64, _everything, None, False),
        (f"empty_shard_sp{_sp}", _sp, _sp - 1, torch.float64, _halo(1), 0.0, False),
        (f"own_rows_only_sp{_sp}", _sp, 10, torch.float64, lambda sp, own: own, None, False),
        (f"bf16_halo2_sp{_sp}", _sp, 11, torch.bfloat16, _halo(2), 0.0, False),
    ]
    GRAD_CASES.append((f"pool_neg_inf_sp{_sp}", _sp, 9, torch.float64, _pool_windows,
                       -math.inf, True))


def _grad_inputs(index, sp, h, dtype):
    """The whole map (N, H, W, C) and every rank's cotangent of its output
    (small integers in bf16, so that every sum is exact)."""
    gen = torch.Generator().manual_seed(100 + index)
    full = torch.randn((2, h, 5, 3), generator=gen, dtype=torch.float64).to(dtype)

    def cotangent(rank, shape):
        g = torch.Generator().manual_seed(1000 * index + rank)
        if dtype == torch.bfloat16:
            return torch.randint(-4, 5, shape, generator=g).to(dtype)
        return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)

    return full, cotangent


def _window_out(win, pooled):
    if not pooled:
        return win
    return F.max_pool2d(win.permute(0, 3, 1, 2), 3, stride=2, padding=(0, 1),
                        ceil_mode=True).permute(0, 2, 3, 1)


def _plain(full, need, h, pad):
    a, b = need
    c0, c1 = spatial.clip((a, b), h)
    rows = full[:, c0:c1]
    if pad is None or b <= a:
        return rows
    return F.pad(rows, (0, 0, 0, 0, c0 - a, b - c1), value=pad)


def _run_grad_cases(world):
    """Every case: this rank's gradient of its rows through the exchange
    equals the rows of the gradient through plain slicing; all ranks'
    verdicts."""
    out = {}
    for index, (name, sp, h, dtype, needs, pad, pooled) in enumerate(GRAD_CASES):
        if world % sp:
            continue
        space = spatial.space_group(sp)
        full, cotangent = _grad_inputs(index, sp, h, dtype)
        own = space.split(h)
        need = needs(sp, own)
        mine = full[:, slice(*own[space.index])].clone().requires_grad_()
        with spatial.training(space):
            if pad is None:
                win = spatial.fetch_rows(mine, own, need, space)
            else:
                win = spatial.fetch_window(mine, h, need, space, pad)
            y = _window_out(win, pooled)
            loss = spatial.join((y * cotangent(space.index, y.shape)).sum(), space)
            loss.backward()
        # the plain gradient: every rank's window sliced from the whole map
        whole = full.clone().requires_grad_()
        total = 0
        for r in range(sp):
            y_r = _window_out(_plain(whole, need[r], h, pad), pooled)
            total = total + (y_r * cotangent(r, y_r.shape)).sum()
        total.backward()
        want = whole.grad[:, slice(*own[space.index])]
        got = mine.grad if mine.grad is not None else torch.zeros_like(mine)
        ok = got.shape == want.shape and torch.allclose(got.double(), want.double(),
                                                        rtol=0, atol=1e-12)
        if dtype == torch.bfloat16:
            ok = ok and torch.equal(got, want)
        out[name] = bool(ddp.all_gather(torch.tensor(int(ok))).min())
    return out


# -- the SP steps in the ranks ------------------------------------------------

def _empty_shard_grads(state_dict) -> bool:
    """At sp 4 one rank owns no row of the target's os8 maps: a forward and
    backward under ``spatial.training`` still gives every parameter a
    gradient on every rank (zero where the rank has no rows)."""
    from maxsquareloss_torch.models.deeplabv2 import valid_logits_hw

    space = spatial.space_group(4)
    assert valid_logits_hw(TGT_HW)[0] == 3 and spatial.rows(3, 4, 0) == (0, 0)
    model = _port_model(state_dict, TrainConfig(blocks=BLOCKS))
    x = torch.from_numpy(_batches()[0][2])[:, slice(*space.own(TGT_HW[0]))]
    with spatial.training(space):
        aux, main = model(x, space=space, in_h=TGT_HW[0])
        spatial.join(aux.sum() + main.sum(), space).backward()
    return all(p.grad is not None for p in model.parameters())


def _preempt_and_resume(work: str, state_dict) -> list:
    """``Trainer --sp 2`` (the supervised trainer over the target crops, one
    image a step): uninterrupted to iteration 4; then a run whose rank 1
    alone sees SIGTERM after step 1 (``--preempt_sync_steps 2``: both ranks
    stop at 2, rank 0 writes one mid-epoch checkpoint), resumed with
    ``--continue_training`` to 4. Returns (where each run stopped, the
    checkpoints written, the losses of both runs at iterations 3 and 4)."""
    from maxsquareloss_torch.data.loader import SegDataLoader
    from maxsquareloss_torch.data.synthetic import SyntheticSegDataset
    from maxsquareloss_torch.train import checkpoint as ckpt_lib
    from maxsquareloss_torch.train import trainer as trainer_mod

    def run(name, **kw):
        group, groups = spatial.data_groups(2)
        train = SegDataLoader(SyntheticSegDataset(length=8, hw=TGT_HW, seed=8), batch_size=1,
                              num_workers=1, shard_index=group, shard_count=groups)
        cfg = _cfg("sp2_supervised", sp=2, checkpoint_dir=os.path.join(work, name),
                   iter_stop=4, epoch_num=1, preempt_sync_steps=2, tqdm=False, **kw)
        return trainer_mod.Trainer(cfg, train, None,
                                   model=_port_model(state_dict, TrainConfig(blocks=BLOCKS)))

    def losses(tr):
        with open(os.path.join(tr.cfg.checkpoint_dir, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        return [r["value"] for r in rows if r["tag"] == "train/loss" and r["step"] > 2]

    whole = run("whole")
    whole.train()
    saves = []
    real_save = ckpt_lib.save_checkpoint

    def counted_save(*args, **kw):
        saves.append(kw.get("epoch_batch"))
        return real_save(*args, **kw)

    trainer_mod.ckpt_lib.save_checkpoint = counted_save
    try:
        cut = run("cut")
        run_step = cut._run_step

        def step_then_flag(batch):
            out = run_step(batch)
            if ddp.rank() == 1 and cut.state.iteration == 1:
                cut._preempt_requested = True
            return out

        cut._run_step = step_then_flag
        cut.train()
    finally:
        trainer_mod.ckpt_lib.save_checkpoint = real_save
    resumed = run("cut", continue_training=True)
    resumed.main()
    return [whole.state.iteration, cut.state.iteration, float(cut.preempted), len(saves),
            resumed.state.iteration, *(losses(resumed) if ddp.is_main() else [0, 0]),
            *(losses(whole) if ddp.is_main() else [0, 0])]


def _worker(rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    try:
        ddp.init_distributed("gloo", f"file://{work}/rendezvous", world, rank)
        state_dict = torch.load(os.path.join(work, "weights.pt"))
        out = {"grads": _run_grad_cases(world), "steps": {}, "replicas_equal": {}}
        for case, (w, sp, _, _) in CASES.items():
            if w != world:
                continue
            group, groups = spatial.data_groups(sp)
            per = GLOBAL_BATCH // groups
            metrics, after_1, model = _run_steps(case, state_dict, sp,
                                                 slice(group * per, (group + 1) * per))
            flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
            out["replicas_equal"][case] = bool((ddp.all_gather(flat) == flat).all())
            out["steps"][case] = metrics
            if rank == 0:
                torch.save(after_1, os.path.join(work, f"params_{case}.pt"))
        if world == 4:
            out["empty_shard_grads"] = bool(ddp.all_gather(
                torch.tensor(int(_empty_shard_grads(state_dict)))).min())
        else:
            out["preempt"] = ddp.all_gather(torch.tensor(
                _preempt_and_resume(work, state_dict), dtype=torch.float64)).tolist()
        if rank == 0:
            torch.save(out, os.path.join(work, "result.pt"))
        ddp.shutdown()
    except BaseException:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def weights():
    """The JAX package's weights (key 0), heads scaled up and BN randomised
    as in ``tests/test_torch_steps.py``, as pytrees and as the port's state
    dict."""
    import jax

    from maxsquareloss_torch.convert import state_dict_from_jax
    from maxsquareloss_tpu.models import deeplabv2 as jmodel

    params, frozen = jmodel.init_deeplabv2(
        jax.random.key(0), jmodel.DeepLabV2Config(num_classes=19, blocks=BLOCKS))
    params = jax.tree.map(np.array, params)
    for head in ("layer5", "layer6"):
        for conv in params[head]["convs"]:
            conv["w"] = conv["w"] * HEAD_SCALE
    rng = np.random.default_rng(21)
    frozen = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, size=v.shape).astype(np.float32), frozen)
    return params, frozen, state_dict_from_jax(params, frozen)


def _run_jax(params, frozen):
    """The JAX package's one-device UDA step (``IW_maxsquare``) on the global
    batches: (metrics a step, the port's state dict after step 1)."""
    import jax
    import jax.numpy as jnp

    from maxsquareloss_torch.convert import state_dict_from_jax
    from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
    from maxsquareloss_tpu.train import steps as jsteps

    jcfg = JTrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5, data_parallel=False, **IW)
    step = jsteps.make_uda_train_step(jcfg, frozen)
    state = jsteps.make_train_state(jax.tree.map(jnp.array, params))
    metrics, after_1 = [], None
    for batch in _batches():
        state, m = step(state, *(jnp.asarray(a) for a in batch))
        metrics.append({k: float(v) for k, v in m.items()})
        if after_1 is None:
            after_1 = state_dict_from_jax(jax.tree.map(np.array, state.params), frozen)
    return metrics, after_1


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory, weights):
    """Both worlds' groups, started together; meanwhile, in this process,
    the one-process references and the JAX step. ({world: (result, its
    directory)}, {case: one-process (metrics, parameters after step 1)},
    the JAX (metrics, parameters after step 1))."""
    ctx = mp.get_context("spawn")
    procs, works = [], {}
    for world in WORLDS:
        work = str(tmp_path_factory.mktemp(f"sp_train_world{world}"))
        torch.save(weights[2], os.path.join(work, "weights.pt"))
        works[world] = work
        for rank in range(world):
            p = ctx.Process(target=_worker, args=(rank, world, work), daemon=True)
            p.start()
            procs.append(p)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reference = {case: _run_steps(case, weights[2])[:2] for case in CASES}
        jax_reference = _run_jax(*weights[:2])
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
    results = {w: (torch.load(os.path.join(work, "result.pt")), work)
               for w, work in works.items()}
    return results, reference, jax_reference


def _rel_l2_changes(got: dict, want: dict, start: dict) -> dict:
    out = {}
    for name, w in want.items():
        change = w.detach().double() - start[name].double()
        out[name] = float(((got[name].detach().double() - start[name].double()) - change).norm()
                          / change.norm())
    return out


GRAD_PARAMS = [(c[0], w) for c in GRAD_CASES for w in WORLDS if w % c[1] == 0]


@pytest.mark.parametrize("name,world", GRAD_PARAMS, ids=[f"{n}_world{w}" for n, w in GRAD_PARAMS])
def test_exchange_backward_equals_plain_slicing(sp_runs, name, world):
    """Every rank's gradient of its rows through the exchange equals its rows
    of the gradient through slicing the whole map (float64 within 1e-12,
    bf16 bitwise)."""
    assert sp_runs[0][world][0]["grads"][name]


@pytest.mark.parametrize("case", list(CASES))
def test_sp_step_equals_the_one_process_step(sp_runs, weights, case):
    world, sp = CASES[case][:2]
    (result, work), reference = sp_runs[0][world], sp_runs[1]
    bf16 = "compute_dtype" in CASES[case][3]
    assert result["replicas_equal"][case], "the ranks' parameters differ after the steps"
    got, want = result["steps"][case], reference[case][0]
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), f"step {i}: {sorted(g)} vs {sorted(w)}"
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=BF16_STEP_RTOL if bf16 else 1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    params = torch.load(os.path.join(work, f"params_{case}.pt"))
    errs = _rel_l2_changes(params, reference[case][1], weights[2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= (BF16_PARAM_RTOL_L2 if bf16 else 1e-4), \
        f"{worst}: change off by {errs[worst]:.3g} (relative L2)"
    if not bf16:
        diff = max(float((params[n] - reference[case][1][n]).abs().max()) for n in params)
        assert diff <= 2e-6, diff
    if CASES[case][2]:  # the guidance path is exercised, not all-ignored
        assert got[0]["guidance_valid_frac"] > 0.0


def test_sp_step_equals_the_jax_one_device_step(sp_runs, weights):
    """The sp 2 UDA step against the JAX package's one-device step on the
    global batch, at ``tests/test_torch_steps.py``'s bounds."""
    want, jax_after = sp_runs[2]
    result, work = sp_runs[0][2]
    for i, (g, w) in enumerate(zip(result["steps"]["sp2_iw_fp32"], want)):
        assert set(g) == set(w), f"step {i}: {sorted(g)} vs {sorted(w)}"
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=5e-4, atol=1e-7, err_msg=f"step {i} {k}")
    params = torch.load(os.path.join(work, "params_sp2_iw_fp32.pt"))
    errs = _rel_l2_changes(params, {n: jax_after[n] for n in params}, weights[2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, f"{worst}: change off by {errs[worst]:.3g} (relative L2)"


def test_empty_shards_give_every_parameter_a_gradient(sp_runs):
    assert sp_runs[0][4][0]["empty_shard_grads"]


def test_preemption_and_resume_under_sp(sp_runs):
    """Lockstep preemption as under DDP: rank 1 alone flags SIGTERM after
    step 1, both ranks of the space group stop at the sync boundary 2, rank
    0 alone writes the one checkpoint; every rank resumes from it to
    iteration 4, whose losses equal the uninterrupted run's."""
    (r0, r1) = sp_runs[0][2][0]["preempt"]
    for r in (r0, r1):
        assert r[:3] == [4, 2, 1.0] and r[4] == 4
    assert (r0[3], r1[3]) == (1, 0)
    assert r0[5:7] == r0[7:9] and all(math.isfinite(v) for v in r0[5:])


# -- the config checks ----------------------------------------------------------

def _parse(argv):
    from maxsquareloss_torch.config import add_train_args, add_uda_train_args

    return add_uda_train_args(add_train_args(argparse.ArgumentParser())).parse_args(argv)


SIZES = ["--crop_size", "64,32", "--base_size", "64,32", "--target_crop_size", "64,32",
         "--target_base_size", "64,32"]


@pytest.mark.parametrize("name", ["crop_size", "target_crop_size", "base_size"])
def test_sp_must_divide_each_height(tmp_path, name):
    from maxsquareloss_torch.config import config_from_args

    with pytest.raises(ValueError, match=f"--sp 4 must divide the image height: {name} H = 30"):
        config_from_args(_parse(["--checkpoint_dir", str(tmp_path), *SIZES, f"--{name}",
                                 "64,30", "--sp", "4"]))


@pytest.mark.parametrize("flags", [["--concat_batches", "true"], ["--remat", "stages"]],
                         ids=["concat", "remat"])
def test_sp_with_concat_or_remat_raises_naming_item_2d(tmp_path, monkeypatch, flags):
    """Both compose with ``--sp`` (``tests/test_torch_spatial_canvas_remat.py``
    runs them): the trainers' checks take them; with ``--quantize int8``
    the run still raises, as in the JAX package."""
    from maxsquareloss_torch.config import check_supported, config_from_args

    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = ["--checkpoint_dir", str(tmp_path), *SIZES, "--sp", "2", *flags]
    cfg = config_from_args(_parse(argv))
    assert cfg.sp == 2 and (cfg.concat_batches or cfg.remat == "stages")
    check_supported(cfg)
    with pytest.raises(ValueError, match="does not compose with --sp 2"):
        config_from_args(_parse([*argv, "--quantize", "int8"]))


def test_trainers_need_sp_processes(tmp_path):
    """In one process ``--sp 2`` raises: it needs a space group of two."""
    from maxsquareloss_torch.tools import solve_gta5

    with pytest.raises(ValueError, match="--sp 2 does not divide the 1 process"):
        solve_gta5.main(["--checkpoint_dir", str(tmp_path), *SIZES, "--device", "cpu",
                         "--sp", "2"])


def test_sp_model_refuses_remat_and_canvas_under_grad(weights):
    """Stage remat with grad and canvas masks compose with the spatially
    partitioned forward: at a space group of one rank (every window its own
    rows, no exchange) the forward equals the plain forward's within 1e-5
    and each parameter's gradient within 1e-5 relative L2, with both at
    once."""
    from maxsquareloss_torch.models.deeplabv2 import make_canvas_masks

    space = spatial.SpaceGroup(1, 0, (0,))
    model = _port_model(weights[2], TrainConfig(blocks=BLOCKS, remat="stages"))
    x = torch.from_numpy(_batches()[0][0][:1, :16, :16].copy())
    masks = make_canvas_masks((16, 16), [(1, (16, 8))])
    outs, grads = [], []
    for kw in ({}, {"space": space, "in_h": 16}):
        model.zero_grad(set_to_none=True)
        with spatial.training(kw.get("space")):
            aux, main = model(x, masks=masks, **kw)
            (aux.square().sum() + main.square().sum()).backward()
        outs.append((aux.detach(), main.detach()))
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(outs[0], outs[1]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    # the stem's weight gradient sums its padded window in another order
    worst = max(float((b - a).norm() / a.norm()) for a, b in zip(*grads))
    assert worst <= 1e-5, f"a gradient is off by {worst:.3g} (relative L2)"
