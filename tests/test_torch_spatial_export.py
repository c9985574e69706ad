"""The sharded serving export (``tools.export_inference --sp N``) on the
CPU: the port's counterpart of the JAX tool's ``--sp`` artifact, one graph
a rank of a space group, the row exchanges as the custom ops
``msl::sp_fetch_rows`` and ``msl::sp_all_rows``.

Gloo ranks (worlds 2 and 4, started once per module, one torch thread
each) export and check sp 2 (fp32, bf16 with bf16 parameters embedded,
and 0.75,1.0 + flip) and sp 4 (fp32, bf16); meanwhile this process exports
the one-process artifacts of the same ``.pth`` and runs the JAX package's
``make_serving_fn``:

- ``--load --selftest``: every rank's artifact equals its live ``--sp``
  graph (``predict_core(..., space)``, its rows gathered on every rank)
  exactly;
- each rank's graph holds the exchange ops the same number of times, with
  the same rows, in the same order, each taking the token the one before
  returned (so none is dead code, nor merged with another);
- the whole map each rank returns is the same on every rank, and >= 99.9 %
  equal to the one-process artifact's and to the JAX serving function's
  trainIds (fp32 sums in another order flip only near-ties; bf16 as the
  one-process bf16 artifact, ``tests/test_torch_export.py``);
- ``torchrun --nproc_per_node 2 -m maxsquareloss_torch.tools.
  export_inference --sp 2``: one ``.pt2`` a rank and a sidecar that names
  ``sp``, the files and each rank's input rows; ``--load --selftest`` under
  ``torchrun`` passes on every rank;
- ``--sp`` with ``--quantize int8``, and ``--sp`` that does not divide the
  height, raise before the checkpoint is read.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
from maxsquareloss_torch.optim import make_sgd
from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.tools import export_inference as ex
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train.steps import model_config

sys.path.insert(0, ".")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = "2,2,2,2"  # an identity block in every layer
HW = (32, 64)  # os4 maps of 9 rows, os8 of 5: uneven shards at sp 2 and sp 4
# name: (world = sp, compute dtype, batch, scales, flip)
CASES = {
    "sp2_fp32": (2, "float32", 2, "1.0", "false"),
    "sp2_bf16": (2, "bfloat16", 1, "1.0", "false"),
    "sp2_fp32_tta": (2, "float32", 1, "0.75,1.0", "true"),
    "sp4_fp32": (4, "float32", 2, "1.0", "false"),
    "sp4_bf16": (4, "bfloat16", 1, "1.0", "false"),
}
WORLDS = (2, 4)
OPS = ("msl.sp_fetch_rows.default", "msl.sp_all_rows.default")


def _argv(ckpt, out, case):
    _, dtype, batch, scales, flip = CASES[case]
    return ["--pretrained_ckpt_file", ckpt, "--output", out, "--hw", ",".join(map(str, HW)),
            "--batch_size", str(batch), "--blocks", BLOCKS, "--compute_dtype", dtype,
            "--scales", scales, "--flip", flip, "--device", "cpu"]


def _batch(case):
    """The selftest's seeded uint8 batch."""
    return np.random.default_rng(0).integers(0, 256, size=(CASES[case][2], *HW, 3)).astype(
        np.uint8)


def _exchanges(path):
    """The exchange ops of an artifact's graph in order: (op, every rank's
    rows, every rank's request), and whether each takes the token that the
    one before returned."""
    graph = torch.export.load(path).graph
    nodes = [n for n in graph.nodes if n.op == "call_function" and str(n.target) in OPS]
    ops = [(str(n.target), list(n.args[2]), list(n.args[3]) if len(n.args) > 4 else [])
           for n in nodes]
    chained = all(
        nxt.args[1].op == "call_function" and nxt.args[1].args[0] is prev
        and nxt.args[1].args[1] == 1 for prev, nxt in zip(nodes, nodes[1:]))
    return ops, chained and str(nodes[-1].target) == OPS[1]


def _worker(rank: int, world: int, work: str, ckpt: str) -> None:
    torch.set_num_threads(1)
    try:
        ddp.init_distributed("gloo", f"file://{work}/rendezvous", world, rank)
        out = {}
        for case, (w, *_rest) in CASES.items():
            if w != world:
                continue
            base = os.path.join(work, case, "m")
            meta = ex.main([*_argv(ckpt, base, case), "--sp", str(world)])
            report = ex.main(["--load", base, "--selftest", "--pretrained_ckpt_file", ckpt])
            path = os.path.join(os.path.dirname(base), meta["files"][rank])
            x = torch.from_numpy(_batch(case)[:, slice(*meta["input_rows"][rank])].copy())
            with torch.no_grad():
                got = torch.export.load(path).module()(x)
            ops, chained = _exchanges(path)
            same = ddp.all_gather(got)
            out[case] = {"report": report, "ops": ops, "chained": chained,
                         "ranks_return_the_same_map": bool((same == got).all()),
                         "output": got.numpy(), "meta": meta}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        ddp.shutdown()
    except BaseException:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(.pth path, its directory): larger heads for fewer near-ties."""
    base = tmp_path_factory.mktemp("sp_export")
    cfg = TrainConfig(blocks=tuple(int(b) for b in BLOCKS.split(",")))
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(7), device="cpu")
    with torch.no_grad():
        for head in (model.layer5, model.layer6):
            for conv in head.conv2d_list:
                conv.weight.mul_(30.0)
    model.pack_weights()
    return ckpt_lib.save_checkpoint(str(base / "ckpt"), model, make_sgd(model, cfg), 0, 0,
                                    0.0), base


def _jax_serving(ckpt, case):
    from maxsquareloss_tpu.config import TrainConfig as JTrainConfig
    from maxsquareloss_tpu.train import checkpoint as jckpt
    from tools.export_inference import make_serving_fn

    _, dtype, _, scales, flip = CASES[case]
    cfg = JTrainConfig(blocks=tuple(int(b) for b in BLOCKS.split(",")), compute_dtype=dtype,
                       device_normalize=True, pretrained_ckpt_file=ckpt, data_parallel=False)
    params, frozen = jckpt.load_torch_pth(ckpt, cfg.num_classes)
    fn = make_serving_fn(cfg, params, frozen, tuple(float(s) for s in scales.split(",")),
                         flip == "true", HW)
    return np.asarray(jax.jit(fn)(_batch(case)))


@pytest.fixture(scope="module")
def sp_runs(served, tmp_path_factory):
    """Both worlds' groups, started together; meanwhile, in this process,
    the one-process artifacts and the JAX serving function. ({world: [each
    rank's results]}, {case: one-process trainIds}, {case: JAX trainIds})."""
    ckpt, base = served
    ctx = mp.get_context("spawn")
    procs, works = [], {}
    for world in WORLDS:
        works[world] = str(tmp_path_factory.mktemp(f"sp_export_world{world}"))
        for rank in range(world):
            p = ctx.Process(target=_worker, args=(rank, world, works[world], ckpt), daemon=True)
            p.start()
            procs.append(p)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one, jax_ref = {}, {}
    try:
        for case in CASES:
            out = str(base / f"one_{case}")
            ex.main(_argv(ckpt, out, case))
            with torch.no_grad():
                one[case] = torch.export.load(out + ".pt2").module()(
                    torch.from_numpy(_batch(case))).numpy()
            jax_ref[case] = _jax_serving(ckpt, case)
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
    ranks = {w: [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(w)] for w, work in works.items()}
    return ranks, one, jax_ref


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_artifact_equals_its_live_sp_graph(sp_runs, case):
    """``--load --selftest`` on every rank: exact, and the graph launches
    the eval kernel's op once an identity block whose map the rank owns
    rows of (none launch here: the CPU runs the plain version)."""
    world = CASES[case][0]
    for rank, result in enumerate(sp_runs[0][world]):
        report = result[case]["report"]
        assert report["selftest"] == "OK" and report["rank"] == rank, report
        assert report["rank_equal"] == [True] * world
        assert report["output_shape"] == [CASES[case][2], *HW]
        assert report["rank_artifact_kernel_launches"] == report["rank_live_kernel_launches"]


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_graph_holds_the_same_chained_exchanges(sp_runs, case):
    ranks = sp_runs[0][CASES[case][0]]
    ops = [r[case]["ops"] for r in ranks]
    assert ops[0] and all(o == ops[0] for o in ops), [len(o) for o in ops]
    assert [op for op, *_ in ops[0]].count(OPS[1]) == 1 and ops[0][-1][0] == OPS[1]
    assert all(r[case]["chained"] for r in ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_sp_artifact_matches_one_process_and_jax(sp_runs, case):
    ranks, one, jax_ref = sp_runs
    results = [r[case] for r in ranks[CASES[case][0]]]
    got = results[0]["output"]
    assert all(r["ranks_return_the_same_map"] for r in results)
    assert got.shape == (CASES[case][2], *HW) and got.dtype == np.int32
    for name, want in (("one process", one[case]), ("JAX", jax_ref[case])):
        share = float((got == want).mean())
        print(f"{case}: trainIds equal to the {name} artifact's on {share:.5f}")
        assert share >= 0.999, (name, share)


def test_sp_sidecar_names_sp_the_files_and_each_rank_rows(sp_runs):
    meta = sp_runs[0][4][0]["sp4_fp32"]["meta"]
    assert meta["sp"] == 4 and meta["files"] == [f"m.rank{r}.pt2" for r in range(4)]
    assert meta["input_rows"] == [[0, 8], [8, 16], [16, 24], [24, 32]]
    assert meta["input_shape"] == [2, *HW, 3] and "space_group(4)" in meta["consume"]
    assert all(r["sp4_fp32"]["meta"] == meta for r in sp_runs[0][4])


def test_export_sp_cli_under_torchrun(served, tmp_path):
    """``torchrun --nproc_per_node 2 -m maxsquareloss_torch.tools.
    export_inference --sp 2``, then ``--load --selftest`` the same way."""
    ckpt = served[0]
    base = str(tmp_path / "serve" / "m")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "maxsquareloss_torch.tools.export_inference"]
    export = subprocess.run([*run, *_argv(ckpt, base, "sp2_bf16"), "--sp", "2"], cwd=REPO,
                            env=env, capture_output=True, text=True, timeout=300)
    assert export.returncode == 0, export.stdout[-3000:] + export.stderr[-3000:]
    meta = json.load(open(base + ".json"))
    assert meta["sp"] == 2 and meta["embed_dtype"] == "bfloat16"
    assert sorted(os.listdir(tmp_path / "serve")) == ["m.json", "m.rank0.pt2", "m.rank1.pt2"]
    check = subprocess.run([*run, "--load", base, "--selftest", "--pretrained_ckpt_file", ckpt],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert check.returncode == 0, check.stdout[-3000:] + check.stderr[-3000:]
    report = json.loads(check.stdout.strip().splitlines()[-1])
    assert report["selftest"] == "OK" and report["rank_equal"] == [True, True]


@pytest.mark.parametrize("flags,match", [
    (["--quantize", "int8", "--calib_images", "x/*.png"], "does not compose with --sp"),
    (["--hw", "31,64"], "must divide the input height"),
], ids=["int8", "height"])
def test_export_sp_refusals_come_before_the_checkpoint(served, tmp_path, monkeypatch, flags,
                                                       match):
    def no_load(*args, **kw):
        raise AssertionError("the checkpoint was read")

    monkeypatch.setattr(ex, "_model", no_load)
    with pytest.raises(ValueError, match=match):
        ex.main([*_argv(served[0], str(tmp_path / "m"), "sp2_fp32"), *flags, "--sp", "2"])
