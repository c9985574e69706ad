"""Training under spatial partitioning (``--sp``) with ``--concat_batches
true`` (the masked canvas on row shards) and with ``--remat stages`` (the
recompute replays the rows the first forward received) on the CPU: the
port's counterpart of the JAX package's ``'space'`` mesh, where GSPMD
partitions the canvas step and ``jax.checkpoint`` like any other op.

Gloo ranks (worlds 2 and 4, started once per module, one torch thread
each), meanwhile the references in this process, two steps each from the
JAX package's weights (heads scaled up so that the guidance threshold
passes on some pixels, BN randomised, as ``tests/test_torch_spatial_train.py``):

- the SP concat step and the SP remat step against the port's one-process
  concat and remat steps on the global batch: fp32 at sp 2, at sp 4 (the
  canvas's os4 maps split unevenly; the target's os8 rows are 3 of the
  canvas's 4, so one rank's canvas logits hold only the target's padding)
  and at dp2 x sp2, both options together at sp 2, and bf16 at sp 2;
- the fp32 SP concat step against the JAX package's one-device concat step
  (``tests/test_torch_steps.py``'s bounds);
- a remat step makes exactly the exchanges, and moves exactly the bytes,
  of the step without remat, forward and backward;
- a rank whose canvas rows hold only a batch's padding gives every
  parameter a gradient;
- every rank holds the same parameters after the steps.

Tolerances: those of ``tests/test_torch_spatial_train.py`` (``PERF.md``
section 2's ``--sp`` training row): fp32 metrics rel 1e-5, parameter
changes 1e-4 relative L2, parameters 2e-6 absolute; bf16 metrics 1.1e-2,
changes 1.4e-2; against JAX 5e-4 and 1e-3.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.parallel import ddp, spatial

BLOCKS = (2, 2, 2, 2)
# unequal crops: a canvas of 24x48; the target's os8 maps have 3 valid rows
# of the canvas's 4 and 4 valid columns of 6
SRC_HW, TGT_HW = (24, 48), (16, 32)
GLOBAL_BATCH = 2
STEPS = 2
HEAD_SCALE = 40.0
IW = {"target_mode": "IW_maxsquare"}
CONCAT, REMAT, BF16 = {"concat_batches": True}, {"remat": "stages"}, {"compute_dtype": "bfloat16"}
# name: (world, sp, config fields)
CASES = {
    "sp2_fp32": (2, 2, IW),
    "sp2_concat_fp32": (2, 2, {**IW, **CONCAT}),
    "sp2_remat_fp32": (2, 2, {**IW, **REMAT}),
    "sp2_concat_remat_fp32": (2, 2, {**IW, **CONCAT, **REMAT}),
    "sp2_concat_bf16": (2, 2, {**IW, **CONCAT, **BF16}),
    "sp2_remat_bf16": (2, 2, {**IW, **REMAT, **BF16}),
    "sp4_fp32": (4, 4, IW),
    "sp4_concat_fp32": (4, 4, {**IW, **CONCAT}),
    "sp4_remat_fp32": (4, 4, {**IW, **REMAT}),
    "dp2xsp2_fp32": (4, 2, IW),
    "dp2xsp2_concat_fp32": (4, 2, {**IW, **CONCAT}),
    "dp2xsp2_remat_fp32": (4, 2, {**IW, **REMAT}),
}
COMPARED = [c for c in CASES if not c.endswith("sp2_fp32") and c != "sp4_fp32"]
BF16_STEP_RTOL, BF16_PARAM_RTOL_L2 = 1.1e-2, 1.4e-2
WORLDS = (2, 4)


def _cfg(case: str, **kw) -> TrainConfig:
    return TrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5, device="cpu",
                       **CASES[case][2], **kw)


def _batches():
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


def _run_steps(case: str, state_dict, sp: int = 1, images=slice(None)) -> dict:
    """``STEPS`` UDA steps of the port on ``images`` of each global batch
    under ``--sp sp``: the metrics a step, the parameters after step 1, the
    first step's exchanges (under ``--sp``), whether every parameter had a
    gradient after it, and the model."""
    from maxsquareloss_torch.train import steps as tsteps

    cfg = _cfg(case, sp=sp)
    model = _port_model(state_dict, cfg)
    state = tsteps.make_train_state(model, cfg)
    step = tsteps.make_uda_train_step(cfg)
    space = spatial.space_group(sp)
    out = {"metrics": [], "after_1": None, "stats": None}
    for xs, ys, xt in _batches():
        if space is not None:
            space.reset_stats()
        args = (xs[images], ys[images], xt[images])
        state, m = step(state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
        out["metrics"].append({k: v.item() for k, v in m.items()})
        if out["after_1"] is None:
            out["after_1"] = {n: p.detach().clone() for n, p in model.named_parameters()}
            out["stats"] = None if space is None else dict(space.stats)
            out["every_grad"] = all(p.grad is not None for p in model.parameters())
    out["model"] = model
    return out


def _worker(rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    try:
        ddp.init_distributed("gloo", f"file://{work}/rendezvous", world, rank)
        state_dict = torch.load(os.path.join(work, "weights.pt"))
        out = {}
        for case, (w, sp, _) in CASES.items():
            if w != world:
                continue
            group, groups = spatial.data_groups(sp)
            per = GLOBAL_BATCH // groups
            run = _run_steps(case, state_dict, sp, slice(group * per, (group + 1) * per))
            model = run.pop("model")
            flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
            run["replicas_equal"] = bool((ddp.all_gather(flat) == flat).all())
            run["every_grad_on_every_rank"] = bool(ddp.all_gather(
                torch.tensor(int(run.pop("every_grad")))).min())
            run["stats_by_rank"] = ddp.all_gather(torch.tensor(
                [run["stats"][k] for k in sorted(run["stats"]) if "seconds" not in k],
                dtype=torch.float64)).tolist()
            after_1 = run.pop("after_1")
            if rank == 0:
                torch.save(after_1, os.path.join(work, f"params_{case}.pt"))
            out[case] = run
        if rank == 0:
            torch.save(out, os.path.join(work, "result.pt"))
        ddp.shutdown()
    except BaseException:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def weights():
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


def _run_jax_concat(params, frozen):
    """The JAX package's one-device concat UDA step on the global batches:
    (metrics a step, the port's state dict after step 1)."""
    import jax
    import jax.numpy as jnp

    from maxsquareloss_torch.convert import state_dict_from_jax
    from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
    from maxsquareloss_tpu.train import steps as jsteps

    jcfg = JTrainConfig(blocks=BLOCKS, iter_max=100, threshold=0.5, data_parallel=False,
                        concat_batches=True, **IW)
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
    """({world: (result, its directory)}, {case: the one-process run}, the
    JAX concat step's (metrics, parameters after step 1))."""
    ctx = mp.get_context("spawn")
    procs, works = [], {}
    for world in WORLDS:
        work = str(tmp_path_factory.mktemp(f"sp_canvas_remat_world{world}"))
        torch.save(weights[2], os.path.join(work, "weights.pt"))
        works[world] = work
        for rank in range(world):
            p = ctx.Process(target=_worker, args=(rank, world, work), daemon=True)
            p.start()
            procs.append(p)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reference = {}
        for case in COMPARED:
            key = tuple(sorted(CASES[case][2].items()))
            if key not in reference:
                run = _run_steps(case, weights[2])
                reference[key] = (run["metrics"], run["after_1"])
        jax_reference = _run_jax_concat(*weights[:2])
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


@pytest.mark.parametrize("case", COMPARED)
def test_sp_step_equals_the_one_process_step(sp_runs, weights, case):
    world = CASES[case][0]
    (result, work), reference = sp_runs[0][world], sp_runs[1]
    bf16 = "compute_dtype" in CASES[case][2]
    run = result[case]
    assert run["replicas_equal"], "the ranks' parameters differ after the steps"
    want_metrics, want_after = reference[tuple(sorted(CASES[case][2].items()))]
    for i, (g, w) in enumerate(zip(run["metrics"], want_metrics)):
        assert set(g) == set(w), f"step {i}: {sorted(g)} vs {sorted(w)}"
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=BF16_STEP_RTOL if bf16 else 1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    params = torch.load(os.path.join(work, f"params_{case}.pt"))
    errs = _rel_l2_changes(params, want_after, weights[2])
    worst = max(errs, key=errs.get)
    print(f"{case}: worst change {worst} {errs[worst]:.3g} relative L2")
    assert errs[worst] <= (BF16_PARAM_RTOL_L2 if bf16 else 1e-4), \
        f"{worst}: change off by {errs[worst]:.3g} (relative L2)"
    if not bf16:
        diff = max(float((params[n] - want_after[n]).abs().max()) for n in params)
        assert diff <= 2e-6, diff
    assert run["metrics"][0]["guidance_valid_frac"] > 0.0


def test_sp_concat_step_equals_the_jax_one_device_concat_step(sp_runs, weights):
    want, jax_after = sp_runs[2]
    result, work = sp_runs[0][2]
    for i, (g, w) in enumerate(zip(result["sp2_concat_fp32"]["metrics"], want)):
        assert set(g) == set(w), f"step {i}: {sorted(g)} vs {sorted(w)}"
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=5e-4, atol=1e-7, err_msg=f"step {i} {k}")
    params = torch.load(os.path.join(work, "params_sp2_concat_fp32.pt"))
    errs = _rel_l2_changes(params, {n: jax_after[n] for n in params}, weights[2])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, f"{worst}: change off by {errs[worst]:.3g} (relative L2)"


@pytest.mark.parametrize("remat,plain", [("sp2_remat_fp32", "sp2_fp32"),
                                         ("sp2_concat_remat_fp32", "sp2_concat_fp32"),
                                         ("sp4_remat_fp32", "sp4_fp32"),
                                         ("dp2xsp2_remat_fp32", "dp2xsp2_fp32")])
def test_a_remat_step_makes_the_exchanges_of_the_step_without(sp_runs, remat, plain):
    """Exchanges and bytes, forward and backward, on every rank: the
    recompute replays the first forward's rows and exchanges nothing."""
    result = sp_runs[0][CASES[remat][0]][0]
    got, want = result[remat]["stats_by_rank"], result[plain]["stats_by_rank"]
    assert got == want and min(min(r) for r in got) > 0, (got, want)


@pytest.mark.parametrize("case", ["sp4_concat_fp32", "dp2xsp2_concat_fp32", "sp2_concat_fp32"])
def test_canvas_padding_ranks_give_every_parameter_a_gradient(sp_runs, case):
    """At sp 4 rank 3's canvas logit rows [3, 4) are all target padding
    (the target's os8 maps have 3 valid rows): it gives no valid target
    rows, joins every exchange, and every parameter has a gradient on every
    rank."""
    from maxsquareloss_torch.models.deeplabv2 import valid_logits_hw

    assert valid_logits_hw(SRC_HW)[0] == 4 and valid_logits_hw(TGT_HW)[0] == 3
    assert spatial.rows(4, 4, 3) == (3, 4)
    assert sp_runs[0][CASES[case][0]][0][case]["every_grad_on_every_rank"]
