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
    assert matmul_probe.plan_rows(dtype, k, n) == tm
    assert matmul_probe.smem_bytes(dtype, tm, k, n) <= matmul_probe.SMEM_LIMIT


def test_too_wide_for_shared_memory_raises():
    with pytest.raises(ValueError, match="shared memory"):
        matmul_probe.plan_rows(torch.float32, 8192, 512)


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
