"""The port's fused bottleneck (its plain path on the CPU) against the JAX
package: the live unfused ``_bottleneck`` and the retired Pallas kernel in
interpret mode. Inputs come from a seeded numpy generator; NHWC in, NHWC
out. Tolerance rtol = atol = 1e-5 (fp32, sums over at most 9*Cmid terms in
another order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from experiments.retired_pallas.fused_block import fused_bottleneck as pallas_fused
from maxsquareloss_tpu.models.deeplabv2 import _bottleneck
from maxsquareloss_torch.kernels import fused_block
from maxsquareloss_torch.kernels.fused_block import fused_bottleneck, plan_tiles

CASES = [
    (2, 13, 17, 64, 16, 2),   # H % TH != 0, odd W
    (1, 4, 9, 32, 8, 1),      # H < default tile, d=1
    (1, 9, 11, 32, 8, 4),     # halo (2d) wider than one tile's rows
    (2, 16, 12, 64, 16, 2),   # H % TH == 0
]


def _make_case(rng, n, h, w, cin, cmid):
    """HWIO weights, folded BN with nonzero biases, NHWC x (numpy)."""
    p = {
        "conv1": rng.normal(size=(1, 1, cin, cmid)).astype(np.float32) * 0.1,
        "conv2": rng.normal(size=(3, 3, cmid, cmid)).astype(np.float32) * 0.1,
        "conv3": rng.normal(size=(1, 1, cmid, cin)).astype(np.float32) * 0.1,
    }
    f = {
        name: {
            "scale": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
            # positive-leaning biases: relu(b1) != 0 where conv2 pads h1
            "bias": (rng.normal(size=(c,)) * 0.1 + 0.05).astype(np.float32),
        }
        for name, c in (("bn1", cmid), ("bn2", cmid), ("bn3", cin))
    }
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    return p, f, x


def _bn_args(f):
    return [f[k][v] for k in ("bn1", "bn2", "bn3") for v in ("scale", "bias")]


def _port(p, f, x, d):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last NCHW view
    args = [torch.from_numpy(p[k]) for k in ("conv1", "conv2", "conv3")]
    args += [torch.from_numpy(v) for v in _bn_args(f)]
    return fused_bottleneck(xt, *args, d).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("reference", ["bottleneck", "pallas_interpret"])
@pytest.mark.parametrize("n,h,w,cin,cmid,d", CASES)
def test_port_matches_jax(n, h, w, cin, cmid, d, reference):
    rng = np.random.default_rng(7)
    p, f, x = _make_case(rng, n, h, w, cin, cmid)
    jp = {k: {"w": jnp.asarray(v)} for k, v in p.items()}
    jf = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in f.items()}
    if reference == "bottleneck":
        want = _bottleneck(jp, jf, jnp.asarray(x), stride=1, dilation=d)
    else:
        with pltpu.force_tpu_interpret_mode():
            want = pallas_fused(
                jnp.asarray(x), *(jp[k]["w"] for k in ("conv1", "conv2", "conv3")),
                *(jnp.asarray(v) for v in _bn_args(f)), d,
            )
    before = fused_bottleneck.launches
    got = _port(p, f, x, d)
    assert fused_bottleneck.launches == before  # CPU tensors never reach the kernel
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def _torch_case(dtype=torch.float32):
    p, f, x = _make_case(np.random.default_rng(0), 1, 5, 6, 16, 4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    ws = [torch.from_numpy(p[k]) for k in ("conv1", "conv2", "conv3")]
    bn = [torch.from_numpy(v) for v in _bn_args(f)]
    return xt, ws, bn


def test_wrapper_rejects_wrong_dtype():
    xt, ws, bn = _torch_case(torch.float64)
    with pytest.raises(TypeError, match="float32"):
        fused_bottleneck(xt, *ws, *bn, 1)


def test_wrapper_rejects_wrong_layout():
    xt, ws, bn = _torch_case()
    with pytest.raises(ValueError, match="channels_last"):
        fused_bottleneck(xt.contiguous(), *ws, *bn, 1)  # plain NCHW strides


def test_wrapper_rejects_wrong_shape():
    xt, ws, bn = _torch_case()
    ws[1] = ws[1][:, :, :2]  # conv2 with the wrong input width
    with pytest.raises(ValueError, match="w2"):
        fused_bottleneck(xt, *ws, *bn, 1)


# (N, H, W, Cmid, d): the eval and TTA shapes of a 1024x512 forward, then the
# UDA step's source (1280x640) and target (1024x512) shapes, at their layers'
# widths (Cin = 4 * Cmid)
PLAN_SHAPES = [
    (2, 129, 257, 64, 1), (2, 65, 129, 128, 1), (2, 65, 129, 256, 2),
    (2, 65, 129, 512, 4), (4, 49, 97, 512, 4),
    (4, 161, 321, 64, 1), (4, 81, 161, 128, 1), (4, 81, 161, 256, 2),
    (4, 81, 161, 512, 4), (4, 129, 257, 64, 1), (4, 65, 129, 128, 1),
    (4, 65, 129, 256, 2), (4, 65, 129, 512, 4), (4, 49, 97, 256, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,cmid,d", PLAN_SHAPES)
def test_plan_tiles_fits_and_covers(n, h, w, cmid, d, dtype):
    cin = 4 * cmid
    plan = plan_tiles(n, h, w, cin, cmid, d, sm_count=132, dtype=dtype)
    size = dtype.itemsize
    tw, rs, segs, threads, smem = plan[:5]
    tiles = threads * fused_block.TILE_CHANNELS // cmid       # pixel tiles, conv1/conv2
    tiles3 = threads * fused_block.TILE_CHANNELS // plan.bn3  # pixel tiles, conv3
    assert threads == fused_block.block_threads(cmid) and threads % 32 == 0
    # the shared memory counts the ring (h2 lives in its oldest slot) and the
    # weight and x stages
    p1 = tw + 2 * d
    assert plan.kb in fused_block.K_STAGES and cmid % plan.kb == 0
    assert (smem == fused_block.smem_bytes(tw, cin, cmid, d, plan.kb, size)
            <= fused_block.SMEM_BLOCK_MAX)
    assert smem == size * (plan.ldh * 3 * p1 + 2 * plan.wstage
                           + 2 * plan.xs_px * (plan.kb + fused_block.PAD_BYTES // size))
    assert plan.ldh >= cmid and (plan.ldh * size) % 16 == 0  # 16-byte pixel rows
    assert plan.wstage == plan.kb * max(cmid, plan.bn3)
    assert plan.xs_px >= tiles * plan.px1 >= p1
    # TW is a whole number of pixel tiles in conv2 and conv3; every tile has
    # at most 8 pixels; threads = pixel tiles x channel groups in every conv
    assert tw == tiles * plan.px2 == tiles3 * plan.px3
    assert max(plan.px1, plan.px2, plan.px3) <= fused_block.MAX_PIXEL_TILE
    assert cin % plan.bn3 == 0 and threads % (plan.bn3 // 4) == 0 == threads % (cmid // 4)
    assert tiles * cmid == tiles3 * plan.bn3 == threads * fused_block.TILE_CHANNELS
    # the strips cover the width, the segments cover every chain of rows
    assert -(-w // tw) * tw >= w and (-(-w // tw) - 1) * tw < w
    assert rs * segs >= -(-h // d)
    assert plan.flop_per_l2_weight_byte(size) == 2 * tw / size
    # conv2 and conv3 give every thread a tile; conv1's TW + 2d pixels are
    # no whole number of tiles at layers 1-2, where at most a fifth of the
    # threads idle in it; at layers 3 and 4 every thread works in every conv
    busy = plan.busy_threads(cmid, d)
    assert busy["conv2"] == busy["conv3"] == threads
    assert busy["conv1"] >= 0.8 * threads
    if cmid >= 256:
        assert busy["conv1"] == threads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plan_tiles_r101_tiles(dtype):
    """The tiles the kernel's header note states for a 1024x512 forward, the
    same in bf16 (layer4's TW is pinned by its pixel tiles, not by its
    shared memory)."""
    tws = {(cmid, w): plan_tiles(2, h, w, 4 * cmid, cmid, d, 132, dtype).tw
           for h, w, cmid, d in ((129, 257, 64, 1), (65, 257, 128, 1), (65, 129, 256, 2),
                                 (81, 161, 256, 2), (65, 129, 512, 4))}
    assert tws == {(64, 257): 64, (128, 257): 64, (256, 129): 48, (256, 161): 56,
                   (512, 129): 24}


@pytest.mark.parametrize("cin,cmid", [(64, 16), (384, 96), (1000, 256)])
def test_plan_tiles_rejects_unsupported_widths(cin, cmid):
    with pytest.raises(ValueError, match="Cmid"):
        plan_tiles(1, 9, 9, cin, cmid, 1, sm_count=132)
