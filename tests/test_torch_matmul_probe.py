"""The port's matmul-chain calibration probe (its plain version on the CPU)
against the Pallas kernel of ``experiments/bench_pallas_matmul.py`` in
interpret mode.

The kernel and its ``pallas_call`` are local to that script's ``main()``,
so ``_pallas_chain`` restates them verbatim. Seeded numpy inputs at scale
0.05, as the script makes them. Tolerances: fp32 rtol 1e-5, bf16 rtol 1e-2
(a link's output rounded to bf16 after a sum in another order may move by
one bf16 ulp), each with an atol of the same fraction of the largest
output, since a column sum may fall near zero.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from maxsquareloss_torch.experiments import bench_matmul
from maxsquareloss_torch.kernels import matmul_probe
from maxsquareloss_torch.kernels.matmul_probe import matmul_chain, matmul_chain_plain

ROOT = Path(__file__).resolve().parents[1]
K, N, C = 32, 8, 3
TYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _pallas_chain(t, x, a, b, chain, dtype, odtype):
    """``bench_pallas_matmul.main``'s kernel and pallas_call, verbatim."""
    C, M, K = x.shape
    N = a.shape[1]

    def kernel(t_ref, x_ref, a_ref, b_ref, o_ref):
        # per-cell distinct input block so nothing is grid-invariant;
        # per-call distinct scalar so the relay result cache never hits
        y = x_ref[0] + t_ref[0, 0].astype(dtype)
        for i in range(chain):
            w = a_ref if i % 2 == 0 else b_ref
            y = jax.nn.relu(jnp.dot(
                y, w[...], preferred_element_type=jnp.float32
            ).astype(odtype)).astype(dtype)
        o_ref[0] = jnp.sum(y.astype(jnp.float32), axis=0, keepdims=True)

    return pl.pallas_call(
        kernel,
        grid=(C,),
        in_specs=[
            pl.BlockSpec((1, 1), memory_space=pltpu.SMEM),
            pl.BlockSpec((1, M, K), lambda c: (c, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 1, N), lambda c: (c, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((C, 1, N), jnp.float32),
    )(t, x, a, b)


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, m, K)).astype(np.float32) * 0.05
    a = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    b = rng.normal(size=(N, K)).astype(np.float32) * 0.05
    return np.full((1, 1), 0.3, np.float32), x * 40, a * 40, b * 40


@pytest.mark.parametrize("m", [16, 13], ids=["m16", "ragged_m13"])
@pytest.mark.parametrize("chain", [1, 3])
@pytest.mark.parametrize("types", ["float32", "bfloat16"])
def test_plain_chain_matches_pallas_kernel(types, chain, m):
    jdtype, tdtype, rtol = TYPES[types]
    t, x, a, b = _inputs(m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_chain(
            jnp.asarray(t), *(jnp.asarray(v).astype(jdtype) for v in (x, a, b)),
            chain, jdtype, jdtype))
    got = matmul_chain(torch.from_numpy(t), *(torch.from_numpy(v).to(tdtype) for v in (x, a, b)),
                       chain, tdtype)
    assert got.shape == (C, 1, N) and got.dtype == torch.float32
    assert np.abs(want).max() > 1.0  # the chain does not vanish
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_mixed_types_match_pallas_kernel():
    """bf16 operands with fp32 products (``--out_dtype float32``)."""
    t, x, a, b = _inputs(16, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_chain(
            jnp.asarray(t), *(jnp.asarray(v).astype(jnp.bfloat16) for v in (x, a, b)),
            3, jnp.bfloat16, jnp.float32))
    got = matmul_chain(torch.from_numpy(t),
                       *(torch.from_numpy(v).to(torch.bfloat16) for v in (x, a, b)), 3,
                       torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("chain", [0, 2, 4])
def test_even_chain_raises(chain):
    t, x, a, b = (torch.from_numpy(v) for v in _inputs(16))
    with pytest.raises(ValueError, match="odd"):
        matmul_chain(t, x, a, b, chain, torch.float32)


def test_bad_shapes_and_types_raise():
    t, x, a, b = (torch.from_numpy(v) for v in _inputs(16))
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        matmul_chain(t, x, a.T.contiguous(), b, 3, torch.float32)
    with pytest.raises(TypeError):
        matmul_chain(t, x.half(), a.half(), b.half(), 3, torch.float32)
    with pytest.raises(TypeError):
        matmul_chain(t, x, a, b, 3, torch.float16)
    with pytest.raises(TypeError, match="a is"):
        matmul_chain(t, x, a.bfloat16(), b, 3, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_chain(t, x.transpose(1, 2).contiguous().transpose(1, 2), a, b, 3, torch.float32)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    t, x, a, b = (torch.from_numpy(v) for v in _inputs(13))
    before = matmul_chain.launches
    got = matmul_chain(t, x, a, b, 3, torch.float32)
    assert matmul_chain.launches == before
    assert torch.equal(got, matmul_chain_plain(t, x, a, b, 3, torch.float32))


@pytest.mark.parametrize("dtype,k,n,tm", [
    (torch.bfloat16, 1024, 256, 64), (torch.bfloat16, 2048, 512, 32),
    (torch.float32, 1024, 256, 32), (torch.float32, 2048, 512, 16),
])
def test_row_tile_fits_shared_memory(dtype, k, n, tm):
    """The defaults and the layer-4 widths take the row tiles the design
    names, within one block's 227 KB."""
    plan = matmul_probe.plan_probe(dtype, k, n)
    assert plan.tm == tm
    assert plan.smem_bytes <= matmul_probe.SMEM_LIMIT


def test_too_wide_for_shared_memory_raises():
    with pytest.raises(ValueError, match="shared memory"):
        matmul_probe.plan_probe(torch.float32, 8192, 512)


@pytest.mark.parametrize("k,n", [(1024, 256), (2048, 512), (64, 64)],
                         ids=["defaults", "layer4", "smallest"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plan_ring_fits_and_counts_its_bytes(dtype, k, n):
    """The ring takes what the activation buffers leave of 232,448 bytes, at
    a depth and stage size the kernel has an instance for, and the plan's
    own numbers add up."""
    plan = matmul_probe.plan_probe(dtype, k, n)
    es = torch.finfo(dtype).bits // 8
    wgmma = plan.route == "wgmma"  # no row padding
    pad = 0 if wgmma else matmul_probe.PAD_BYTES // es
    limit = matmul_probe.SMEM_LIMIT - (matmul_probe.SMEM_RESERVE)
    assert plan.smem_bytes <= limit <= matmul_probe.SMEM_LIMIT == 232_448
    assert matmul_probe.MIN_DEPTH <= plan.depth <= matmul_probe.MAX_DEPTH
    assert plan.stage_rows in ((matmul_probe.WGMMA_STAGE_ROWS,) if wgmma
                               else matmul_probe.STAGE_ROWS[dtype])
    assert k % plan.stage_rows == 0 and n % plan.stage_rows == 0
    assert plan.stage_bytes == es * plan.stage_rows * (plan.block_cols + pad)
    assert plan.smem_bytes == es * plan.tm * (k + n + 2 * pad) + plan.depth * plan.stage_bytes
    assert plan.bytes_in_flight == (plan.depth - 1) * plan.stage_bytes
    # one more stage would not fit (or the ring is at its cap)
    assert plan.depth == matmul_probe.MAX_DEPTH or plan.smem_bytes + plan.stage_bytes > limit


@pytest.mark.parametrize("dtype,k,n,flop_per_byte", [
    (torch.bfloat16, 1024, 256, 64.0), (torch.bfloat16, 2048, 512, 32.0),
    (torch.float32, 1024, 256, 16.0), (torch.float32, 2048, 512, 8.0),
])
def test_plan_flop_per_l2_weight_byte(dtype, k, n, flop_per_byte):
    """A block streams each whole weight once for its tm rows: 2 * rows FLOP
    per weight element."""
    plan = matmul_probe.plan_probe(dtype, k, n)
    assert plan.flop_per_l2_weight_byte == flop_per_byte
    per_link_flop = 2 * plan.tm * k * n
    assert per_link_flop / (k * n * plan.elem_bytes) == plan.flop_per_l2_weight_byte


@pytest.mark.parametrize("m", [13, 64, 1000, 1728])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plan_row_tiles_cover_a_cell(dtype, m):
    """The grid is (row tiles, cells): a block works on one cell, the tiles
    cover its M rows and none lies wholly past M."""
    plan = matmul_probe.plan_probe(dtype, 1024, 256)
    tiles = plan.tiles(m)
    assert (tiles - 1) * plan.tm < m <= tiles * plan.tm


def test_kernel_has_an_instance_for_every_plan_and_no_other():
    """The (type, row tile, stage rows) cases compiled into the .cu are the
    ones the planner reaches over K and N in multiples of 64."""
    src = matmul_probe.SOURCE.read_text()
    compiled = {(name == "float", int(tm), int(kb))
                for name, tm, kb in re.findall(r"^\s+MSL_PROBE_CASE\((\w+), (\d+), (\d+)\)$", src, re.M)}
    planned = set()
    for dtype in matmul_probe.DTYPES:
        for k in range(64, 4097, 64):
            for n in range(64, 4097, 64):
                try:
                    plan = matmul_probe.plan_probe(dtype, k, n)
                except ValueError:
                    continue
                if plan.route != "wgmma":
                    planned.add((dtype == torch.float32, plan.tm, plan.stage_rows))
    assert planned == compiled and len(compiled) == 5


def test_wgmma_route_takes_the_defaults_and_not_the_layer4_widths():
    """bf16 at the defaults runs 64-row tiles on the wgmma route; a 64-row
    K 2048 tile does not fit a block, so the layer-4 widths stay on mma.sync
    at 32 rows, and fp32 stays on the CUDA cores."""
    plan = matmul_probe.plan_probe(torch.bfloat16, 1024, 256)
    assert (plan.route, plan.tm, plan.block_cols, plan.stage_rows) == ("wgmma", 64, 256, 32)
    assert plan.smem_bytes + matmul_probe.SMEM_RESERVE <= matmul_probe.SMEM_LIMIT
    assert matmul_probe.plan_probe(torch.bfloat16, 2048, 512).route == "mma_sync"
    assert matmul_probe.plan_probe(torch.bfloat16, 1024, 64).route == "mma_sync"
    assert matmul_probe.plan_probe(torch.float32, 1024, 256).route == "fma"


@pytest.mark.parametrize("kin,nout", [(1024, 256), (256, 1024)])
def test_pack_weight_wgmma_round_trips_and_stages_are_contiguous(kin, nout):
    """pack -> unpack is the identity; element (k, n) sits where the kernel's
    descriptors look for it (pass, 8-row k-block, 8-column block, k, n); a
    stage is one contiguous run."""
    plan = matmul_probe.plan_probe(torch.bfloat16, 1024, 256)
    assert plan.route == "wgmma"
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(kin, nout)).astype(np.float32)).to(torch.bfloat16)
    packed = matmul_probe.pack_weight(w, plan)
    assert packed.is_contiguous() and packed.numel() == w.numel()
    assert torch.equal(matmul_probe.unpack_weight(packed, plan, nout), w)
    flat = packed.reshape(-1)
    for k, n in rng.integers(0, [kin, nout], size=(200, 2)):
        k, n = int(k), int(n)
        block = (n // 256 * (kin // 8) + k // 8) * 32 + n % 256 // 8  # 128-byte core matrix
        assert flat[block * 64 + k % 8 * 8 + n % 8] == w[k, n]
    stage = plan.stage_bytes // 2  # elements, in order
    first = matmul_probe.unpack_weight(flat[:stage].reshape(1, -1, 32, 8, 8), plan, 256)
    assert torch.equal(first, w[:plan.stage_rows, :256])


@pytest.mark.parametrize("dtype,k,n", [
    (torch.float32, 1024, 256), (torch.float32, 2048, 512), (torch.bfloat16, 2048, 512),
    (torch.float32, 256, 64), (torch.bfloat16, 64, 192),
])
def test_pack_weight_rows_round_trips_and_stages_are_contiguous(dtype, k, n):
    """The padded-row routes: both weights of a chain round-trip; stage s of
    a weight is its s-th run of ``stage_bytes``: ``stage_rows`` k-rows of one
    pass, every row padded by 16 bytes, columns past Nout zero."""
    plan = matmul_probe.plan_probe(dtype, k, n)
    assert plan.route in ("fma", "mma_sync")
    rng = np.random.default_rng(7)
    pad = matmul_probe.PAD_BYTES // plan.elem_bytes
    for kin, nout in ((k, n), (n, k)):
        w = torch.from_numpy(rng.normal(size=(kin, nout)).astype(np.float32)).to(dtype)
        packed = matmul_probe.pack_weight(w, plan)
        passes = -(-nout // plan.block_cols)
        assert packed.is_contiguous()
        assert packed.shape == (passes, kin, plan.block_cols + pad)
        assert packed.numel() * plan.elem_bytes == passes * (kin // plan.stage_rows) * plan.stage_bytes
        assert torch.equal(matmul_probe.unpack_weight(packed, plan, nout), w)
        per_stage = plan.stage_bytes // plan.elem_bytes
        last = packed.reshape(-1)[-per_stage:].reshape(plan.stage_rows, plan.block_cols + pad)
        cols = nout - (passes - 1) * plan.block_cols  # of the last pass
        assert torch.equal(last[:, :cols], w[-plan.stage_rows:, -cols:])
        assert not last[:, cols:].any()


@pytest.mark.parametrize("dtype,k,n", [(torch.bfloat16, 256, 256), (torch.float32, 64, 128)],
                         ids=["wgmma", "fma"])
def test_plain_chain_on_unpacked_weights_equals_the_originals(dtype, k, n):
    t = torch.from_numpy(_inputs(16)[0])
    plan = matmul_probe.plan_probe(dtype, k, n)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 16, k)).astype(np.float32) * 0.05).to(dtype)
    a = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.05).to(dtype)
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) * 0.05).to(dtype)
    want = matmul_chain_plain(t, x, a, b, 3, dtype)
    ua = matmul_probe.unpack_weight(matmul_probe.pack_weight(a, plan), plan, n)
    ub = matmul_probe.unpack_weight(matmul_probe.pack_weight(b, plan), plan, k)
    assert torch.equal(matmul_chain_plain(t, x, ua, ub, 3, dtype), want)


def test_entry_point_flags_match_the_reference_script():
    """Every flag of the JAX script, with its default, plus --device."""
    src = (ROOT / "experiments/bench_pallas_matmul.py").read_text()
    ref = dict(re.findall(r'add_argument\("--(\w+)",(?: type=int,)? default=([^,)]+)', src))
    assert set(ref) == {"m", "k", "n", "cells", "chain", "dtype", "iters", "out_dtype"}
    args = vars(bench_matmul.parse_args([]))
    for name, default in ref.items():
        assert str(args[name]) == default.strip('"'), name
    assert args["device"] is None


def test_entry_point_runs_on_the_cpu(capsys):
    out = bench_matmul.main(["--device", "cpu", "--m", "20", "--k", "64", "--n", "64",
                             "--cells", "2", "--iters", "2", "--dtype", "float32",
                             "--out_dtype", "float32"])
    line = capsys.readouterr().out
    assert out["out"].shape == (2, 1, 64) and torch.isfinite(out["out"]).all()
    assert out["flops"] == 2 * 20 * 64 * 64 * 3 * 2
    assert "plain version on cpu" in line and "peak" not in line
    assert "197" not in line


def test_plan_stage_rows_follow_the_route():
    """The FMA loop takes few, large stages; the mma.sync loop the deep ring
    of small ones."""
    defaults = matmul_probe.plan_probe(torch.float32, 1024, 256)
    assert (defaults.route, defaults.stage_rows, defaults.depth) == ("fma", 32, 2)
    layer4 = matmul_probe.plan_probe(torch.bfloat16, 2048, 512)
    assert (layer4.route, layer4.stage_rows, layer4.depth) == ("mma_sync", 16, 4)
