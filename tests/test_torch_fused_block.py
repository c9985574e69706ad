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
from maxsquareloss_torch.models.deeplabv2 import _valid_sizes

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


def _assert_tc_plan(plan, n, h, w, cin, cmid, d):
    """A bf16 (tc route) plan: every conv on wgmma m64 tiles of whole
    warpgroups, conv2 in one pass over all Cmid from the h1 ring in the
    core-matrix layout, everything in 232,448 B with stages deeper than the
    FMA loop's 16 rows."""
    tw, rs, segs, threads, smem = plan[:5]
    p1 = tw + 2 * d
    assert plan.route == "tc"
    assert plan.conv_routes() == {"conv1": "wgmma", "conv2": "wgmma", "conv3": "wgmma"}
    # whole warpgroups; each takes a pass of bn1 (conv1) or bn3 (conv3)
    # columns over their count
    assert threads == fused_block.block_threads(cmid) and threads % fused_block.WG_THREADS == 0
    wgs = threads // fused_block.WG_THREADS
    nw1, nw3 = plan.bn1 // wgs, plan.bn3 // wgs
    assert {nw1, nw3} <= set(fused_block.WGMMA_WIDTHS)
    assert cmid % plan.bn1 == 0 and cin % plan.bn3 == 0
    # the m64 tiles cover conv1's P1 pixels and conv3's TW, with no tile to spare
    m = fused_block.WGMMA_M
    assert m * (plan.mt1 - 1) < p1 <= m * plan.mt1 and m * (plan.mt3 - 1) < tw <= m * plan.mt3
    # fp32 accumulators a thread: MT tiles x NW/2 (128 spill on sm_90a)
    assert plan.mt1 * nw1 // 2 <= 64 and plan.mt3 * nw3 // 2 <= 64
    # stages deeper than the FMA loop's, dividing K, inside the weight buffer
    assert plan.kb1 in fused_block.TC_STAGE_ROWS and plan.kb1 > fused_block.K_STAGES[0]
    assert plan.kb3 in fused_block.TC_STAGE_ROWS and plan.kb3 > fused_block.K_STAGES[0]
    assert cin % plan.kb1 == 0 and cmid % plan.kb3 == 0
    assert plan.wstage == max(plan.kb1 * plan.bn1, plan.kb3 * plan.bn3,
                              fused_block.CONV2_BUFFERS * plan.kb * cmid // 2)
    # shared memory: the h1 window's plane (ldh x Cmid), two weight stages,
    # two x stages and the rows conv1's last m64 tile reads past the second
    # x stage
    overread = fused_block.CORE * max(0, m * plan.mt1 - plan.xs_px)
    assert smem == 2 * (plan.ldh * cmid + 2 * plan.wstage + 2 * plan.xs_px * plan.kb1
                        + overread) <= fused_block.SMEM_BLOCK_MAX
    assert plan.xs_px == p1 | 1
    # the window holds CONV2_ROWS + 2 rows of P1 pixels in one plane of odd
    # stride, h2 takes its first CONV2_ROWS positions at the same stride, and
    # conv3's tiles (from the pass's last row) read no further than shared
    # memory
    r2 = fused_block.CONV2_ROWS
    assert plan.ldh == plan.h2p == ((r2 + 2) * p1) | 1
    last = fused_block.CORE * (plan.h2p * (cmid // 8 - 1) + (r2 - 1) * p1 + m * plan.mt3)
    assert 2 * last <= smem
    # conv3's epilogue tiles (tw x EPI_COLS a warpgroup) lie in the x stages
    assert wgs * tw * fused_block.EPI_COLS <= 2 * plan.xs_px * plan.kb1
    assert nw3 % fused_block.EPI_COLS == 0
    # conv2 on wgmma: one pass over all Cmid (one of the kernel's instances)
    # over conv3's m64 tiles, a ring of stages of kb k-rows inside one tap
    # that the two weight buffers of conv1 and conv3 already hold
    tile = plan.conv2_tile(cmid)
    assert (tile["mt"], tile["nw"]) in fused_block.CONV2_TILES and tile["rows"] == r2 == 2
    assert m * (tile["mt"] - 1) < (r2 - 1) * p1 + tw <= m * tile["mt"]
    assert wgs * tile["nw"] == cmid and tile["mt"] * tile["nw"] // 2 <= 128
    assert plan.kb in fused_block.TC_STAGE_ROWS and cmid % plan.kb == 0
    assert (fused_block.CONV2_BUFFERS * plan.kb * cmid
            <= 2 * max(plan.kb1 * plan.bn1, plan.kb3 * plan.bn3))
    assert tile["stages"] * plan.kb == 9 * cmid
    # its A reads (the last tap, the last channel block, every row of the
    # m64 tiles) stay in shared memory
    a_last = fused_block.conv2_a_start(cmid - fused_block.WGMMA_K, 0, tile["mt"] - 1, 2, 2, d,
                                       p1, plan.ldh)
    assert 2 * (a_last + fused_block.CORE * (plan.ldh + m)) <= smem
    assert plan.px1 == plan.px2 == plan.px3 == 0  # no FMA pixel tiles on the tc route
    assert plan.busy_threads(cmid, d) == {"conv1": threads, "conv2": threads, "conv3": threads}
    # the strips cover the width, the segments cover every chain of rows
    assert -(-w // tw) * tw >= w and (-(-w // tw) - 1) * tw < w
    assert rs * segs >= -(-h // d)
    assert plan.flop_per_l2_weight_byte(2) == tw
    assert len(plan.launch_args()) == 20  # with N, H, W, Cin, Cmid, d: the ABI's 26 ints
    used = plan.m_rows_used(d)
    assert used == {"conv1": p1 / (m * plan.mt1), "conv2": r2 * tw / (m * plan.mt2),
                    "conv3": tw / (m * plan.mt3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,cmid,d", PLAN_SHAPES)
def test_plan_tiles_fits_and_covers(n, h, w, cmid, d, dtype):
    cin = 4 * cmid
    plan = plan_tiles(n, h, w, cin, cmid, d, sm_count=132, dtype=dtype)
    if dtype == torch.bfloat16:
        _assert_tc_plan(plan, n, h, w, cin, cmid, d)
        return
    size = dtype.itemsize
    tw, rs, segs, threads, smem = plan[:5]
    tiles = threads * fused_block.TILE_CHANNELS // cmid       # pixel tiles, conv1/conv2
    tiles3 = threads * fused_block.TILE_CHANNELS // plan.bn3  # pixel tiles, conv3
    assert threads == fused_block.block_threads(cmid) and threads % 32 == 0
    # the shared memory counts the ring (h2 lives in its oldest slot) and the
    # weight and x stages
    p1 = tw + 2 * d
    assert plan.kb in fused_block.K_STAGES and cmid % plan.kb == 0
    assert (smem == fused_block.smem_bytes(tw, cin, cmid, d, plan.kb)
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


# the tc route's TW at R101's 1024x512 shapes, by (Cmid, W)
R101_BF16_TWS = {(64, 257): 96, (128, 257): 96, (256, 129): 48, (256, 161): 56, (512, 129): 28}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plan_tiles_r101_tiles(dtype):
    """The tiles the kernel's header note states for a 1024x512 forward: in
    fp32 layer4's TW is pinned by conv1's pixel tiles; in bf16 (the tc
    route) the m64 tiles set TW, so layers 1-2 take 96 columns (P1 98 of
    two tiles) and layer4 28 (conv2's 4 pixel tiles of 7)."""
    tws = {(cmid, w): plan_tiles(2, h, w, 4 * cmid, cmid, d, 132, dtype).tw
           for h, w, cmid, d in ((129, 257, 64, 1), (65, 257, 128, 1), (65, 129, 256, 2),
                                 (81, 161, 256, 2), (65, 129, 512, 4))}
    if dtype == torch.bfloat16:
        assert tws == R101_BF16_TWS
        return
    assert tws == {(64, 257): 64, (128, 257): 64, (256, 129): 48, (256, 161): 56,
                   (512, 129): 24}


@pytest.mark.parametrize("weight", [3, 4, 8, 12])
def test_tc_tw_holds_over_the_rate_weight(weight, monkeypatch):
    """The tc route's TW at R101's 1024x512 shapes does not hang on the
    planning weight TC_OVER_FMA (the tensor cores' rate over the FMA
    loop's) anywhere from 3 to 12."""
    monkeypatch.setattr(fused_block, "TC_OVER_FMA", weight)
    tws = {(cmid, w): plan_tiles(2, h, w, 4 * cmid, cmid, d, 132, torch.bfloat16).tw
           for h, w, cmid, d in ((129, 257, 64, 1), (65, 257, 128, 1), (65, 129, 256, 2),
                                 (81, 161, 256, 2), (65, 129, 512, 4))}
    assert tws == R101_BF16_TWS


# one plan shape of each layer's widths for the tc route's maps: layer1 and 2
# with P1 above 64 (two m64 tiles), layer3 one tile, layer4 with M below 64
# in both convs
TC_SHAPES = [PLAN_SHAPES[i] for i in (0, 6, 2, 3)]


def _tc_plan(n, h, w, cmid, d):
    return plan_tiles(n, h, w, 4 * cmid, cmid, d, sm_count=132, dtype=torch.bfloat16)


@pytest.mark.parametrize("n,h,w,cmid,d", TC_SHAPES)
def test_tc_stage_maps_are_bijections(n, h, w, cmid, d):
    """The x stage, weight stage and h2 maps put each element in a place of
    its own and fill their buffers; the weight stage's 16-byte piece idx
    lands at 8 idx (the copy loop of ``stage_weights_tc``)."""
    plan = _tc_plan(n, h, w, cmid, d)
    pix, ch = torch.meshgrid(torch.arange(plan.xs_px), torch.arange(plan.kb1), indexing="ij")
    xo = fused_block.x_stage_offset(pix, ch, plan.xs_px).flatten()
    assert torch.equal(xo.sort().values, torch.arange(plan.xs_px * plan.kb1))
    for bn, kb in ((plan.bn1, plan.kb1), (plan.bn3, plan.kb3)):
        k, col = torch.meshgrid(torch.arange(kb), torch.arange(bn), indexing="ij")
        wo = fused_block.w_stage_offset(k, col, bn).flatten()
        assert torch.equal(wo.sort().values, torch.arange(kb * bn))
        idx = torch.arange(kb * bn // 8)
        kr, c0 = fused_block.w_stage_piece(idx, bn)
        assert torch.equal(fused_block.w_stage_offset(kr, c0, bn), 8 * idx)
    pix, ch = torch.meshgrid(torch.arange(plan.h2p), torch.arange(cmid), indexing="ij")
    ho = fused_block.h2_offset(pix, ch, plan.h2p).flatten()
    assert torch.equal(ho.sort().values, torch.arange(plan.h2p * cmid))
    assert plan.h2p == plan.ldh


@pytest.mark.parametrize("n,h,w,cmid,d", TC_SHAPES)
def test_tc_plan_at_every_tw_holds_the_plan(n, h, w, cmid, d):
    """Every TW of ``tc_tws`` with a layout gives a plan with the tc route's
    invariants (the tiles ``experiments/tc_tiles.py`` times), and the
    planner's plan is the one at its TW."""
    cin = 4 * cmid
    plans = [p for tw in fused_block.tc_tws(cmid)
             if (p := fused_block.tc_plan_at(tw, n, h, w, cin, cmid, d, 132)) is not None]
    assert len(plans) >= 2
    for plan in plans:
        _assert_tc_plan(plan, n, h, w, cin, cmid, d)
    chosen = _tc_plan(n, h, w, cmid, d)
    assert chosen == fused_block.tc_plan_at(chosen.tw, n, h, w, cin, cmid, d, 132)


@pytest.mark.parametrize("n,h,w,cmid,d", TC_SHAPES)
def test_tc_epilogue_tile_map(n, h, w, cmid, d):
    """conv3's epilogue tile: each (pixel, column) in a place of its own,
    filling tw x EPI_COLS; a warp's fragment stores (8 pixels x 4 threads
    of 4 bytes, one column group) hit 32 distinct banks, and each quarter
    warp's 16-byte reads (a pixel's 8 pieces) 8 distinct 16-byte bank
    groups."""
    plan = _tc_plan(n, h, w, cmid, d)
    cols = fused_block.EPI_COLS
    pix, col = torch.meshgrid(torch.arange(plan.tw), torch.arange(cols), indexing="ij")
    off = fused_block.epilogue_offset(pix, col).flatten()
    assert torch.equal(off.sort().values, torch.arange(plan.tw * cols))
    lane = torch.arange(32)
    g, tq = lane // 4, lane % 4
    for warp in range(4):
        for t in range(plan.mt3):
            for hh in range(2):
                p = 64 * t + 16 * warp + 8 * hh + g
                for jj in range(cols // 8):
                    word = fused_block.epilogue_offset(p, 8 * jj + 2 * tq) // 2
                    assert len(set((word % 32).tolist())) == 32
    i = torch.arange(plan.tw * (cols // 8))
    piece = fused_block.epilogue_offset(i // (cols // 8), 8 * (i % (cols // 8))) // 8
    assert torch.equal(piece.sort().values, torch.arange(plan.tw * (cols // 8)))
    for q0 in range(0, len(i), 8):
        assert len(set((piece[q0:q0 + 8] % 8).tolist())) == 8


@pytest.mark.parametrize("nw", fused_block.WGMMA_WIDTHS)
def test_tc_fragment_map_covers_the_tile_once(nw):
    rows, cols = fused_block.fragment_rows_cols(nw)
    assert rows.shape == cols.shape == (fused_block.WG_THREADS, nw // 2)
    flat = (rows * nw + cols).flatten()
    assert torch.equal(flat.sort().values, torch.arange(fused_block.WGMMA_M * nw))


def _emulate_tc(a_buf_of_stage, w_buf_of_stage, stages, kb, bn, m_tiles, a_stride, a_start,
                wgs, nw):
    """Emulate the tc route's k loop: per stage its A and weight buffers;
    warpgroup g multiplies its columns [g nw, (g+1) nw) over m_tiles m64
    tiles, each k16 step an A and a B read by the descriptor rule; returns
    the (64 m_tiles, bn) product gathered through the fragment map."""
    m = fused_block.WGMMA_M
    acc = torch.zeros(wgs, m_tiles, m, nw)
    for i in range(stages):
        abuf, wbuf = a_buf_of_stage(i), w_buf_of_stage(i)
        for g in range(wgs):
            for s in range(kb // 16):
                b = fused_block.descriptor_read(wbuf, 2 * (8 * g * nw + 16 * s * bn), 16 * bn, 128,
                                                nw, mn_major=True)
                for t in range(m_tiles):
                    a = fused_block.descriptor_read(abuf, 2 * a_start(i, s, t), 16 * a_stride, 128,
                                                    m)
                    acc[g, t] += a @ b.T
    rows, cols = fused_block.fragment_rows_cols(nw)
    out = torch.full((m * m_tiles, bn), float("nan"))
    for g in range(wgs):
        for t in range(m_tiles):
            # each thread's registers hold D[rows, cols] of its tile
            out[m * t + rows, g * nw + cols] = acc[g, t][rows, cols]
    return out


@pytest.mark.parametrize("conv", ["conv1", "conv3"])
@pytest.mark.parametrize("n,h,w,cmid,d", TC_SHAPES)
def test_tc_emulation_equals_the_product(n, h, w, cmid, d, conv):
    """x and w scattered into the stage buffers through the maps (a
    buffer's rest NaN, so rows past the tile read garbage), read back by
    the descriptors' lbo/sbo rule, multiplied and gathered through the
    fragment map equal x @ w exactly (small integers, exact in fp32)."""
    plan = _tc_plan(n, h, w, cmid, d)
    cin, p1, m = 4 * cmid, plan.tw + 2 * d, fused_block.WGMMA_M
    wgs = plan.threads // fused_block.WG_THREADS
    rng = np.random.default_rng(5)
    if conv == "conv1":
        rows, k, n_out, bn, kb, mt = p1, cin, cmid, plan.bn1, plan.kb1, plan.mt1
    else:
        rows, k, n_out, bn, kb, mt = plan.tw, cmid, cin, plan.bn3, plan.kb3, plan.mt3
    nw = bn // wgs
    a = torch.from_numpy(rng.integers(-3, 4, size=(rows, k)).astype(np.float32))
    wt = torch.from_numpy(rng.integers(-3, 4, size=(k, n_out)).astype(np.float32))
    pix = torch.arange(rows)[:, None]

    def w_buf(i, n0):  # stage i of the pass at column n0, by 16-byte pieces
        buf = torch.full((plan.wstage,), float("nan"))
        idx = torch.arange(kb * bn // 8)
        kr, c0 = fused_block.w_stage_piece(idx, bn)
        for e in range(8):
            buf[8 * idx + e] = wt[i * kb + kr, n0 + c0 + e]
        return buf

    if conv == "conv1":
        # an x stage and what follows it in shared memory up to its end
        size = plan.xs_px * kb + fused_block.CORE * max(0, m * mt - plan.xs_px)

        def a_buf(i):
            buf = torch.full((size,), float("nan"))
            ch = torch.arange(kb)[None, :]
            buf[fused_block.x_stage_offset(pix, ch, plan.xs_px)] = a[:, i * kb:(i + 1) * kb]
            return buf

        for n0 in range(0, n_out, bn):  # the passes over conv1's columns
            got = _emulate_tc(a_buf, lambda i: w_buf(i, n0), k // kb, kb, bn, mt, plan.xs_px,
                              lambda i, s, t: 8 * (2 * s * plan.xs_px + m * t), wgs, nw)
            assert torch.equal(got[:rows], a @ wt[:, n0:n0 + bn])
        return
    # conv3: h2 whole at the window position of a pass's last row, then the
    # rest of the plane and of shared memory
    start = fused_block.CORE * (ROWS - 1) * p1
    buf = torch.full((plan.smem // 2 - start,), float("nan"))
    ch = torch.arange(cmid)[None, :]
    buf[fused_block.h2_offset(pix, ch, plan.h2p)] = a
    for n0 in range(0, n_out, bn):
        got = _emulate_tc(lambda i: buf, lambda i: w_buf(i, n0), k // kb, kb, bn, mt, plan.h2p,
                          lambda i, s, t: 8 * (plan.h2p * (i * kb // 8 + 2 * s) + m * t), wgs,
                          nw)
        assert torch.equal(got[:rows], a @ wt[:, n0:n0 + bn])


# conv2 on wgmma: the identity blocks' (N, H, W, Cmid, d) of R101 in the
# benchmark's cells (the eval protocol's 0.75 / 1 / 1.25 scales with the flip
# at 1024x512, the UDA steps' 1280x640, 1280x760 and 1024x512 crops, serving
# at batch 1) and of the CPU tests' blocks=(2,2,2,2) models at 64x128 and
# 48x96, one case a (W, Cmid, d): N and H do not change the maps
CELL_IMAGES = ((8, 384, 768), (8, 512, 1024), (8, 640, 1280), (4, 640, 1280), (4, 760, 1280),
               (4, 512, 1024), (1, 512, 1024), (2, 64, 128), (2, 48, 96))
R101_WIDTHS = ((64, 1), (128, 1), (256, 2), (512, 4))  # (Cmid, d) of layers 1-4
ROWS = fused_block.CONV2_ROWS  # output rows of a conv2 pass
CONV2_SHAPES = sorted({
    (w, cmid, d): (n, h, w, cmid, d) for n, *hw in CELL_IMAGES for cmid, d in R101_WIDTHS
    for h, w in [_valid_sizes(tuple(hw))["os4" if cmid == 64 else "os8"]]}.values())


@pytest.mark.parametrize("n,h,w,cmid,d", CONV2_SHAPES)
def test_tc_conv2_plan_fits_and_names_its_tile(n, h, w, cmid, d):
    """At every cell's shape the bf16 plan fits 232,448 B with the tc
    route's invariants and puts conv2 on wgmma (the gate passed at layers 3
    and 4, PERF.md) two output rows a pass, with its tile named: rows, m64
    tiles, columns a warpgroup, stage rows and stages."""
    plan = _tc_plan(n, h, w, cmid, d)
    _assert_tc_plan(plan, n, h, w, 4 * cmid, cmid, d)
    assert plan.conv_routes()["conv2"] == "wgmma"
    assert set(plan.conv2_tile(cmid)) == {"rows", "mt", "nw", "kb", "stages"}
    assert plan.smem <= fused_block.SMEM_BLOCK_MAX


@pytest.mark.parametrize("n,h,w,cmid,d", CONV2_SHAPES)
def test_tc_h1_window_layout_is_a_bijection(n, h, w, cmid, d):
    """The h1 window's core-matrix plane puts each of its ldh x Cmid
    (pixel, channel) pairs in a place of its own and fills the plane; its
    ROWS + 2 positions of P1 pixels come first in each channel block."""
    plan = _tc_plan(n, h, w, cmid, d)
    pix, ch = torch.meshgrid(torch.arange(plan.ldh), torch.arange(cmid), indexing="ij")
    off = fused_block.h1_offset(pix, ch, plan.ldh)
    assert torch.equal(off.flatten().sort().values, torch.arange(plan.ldh * cmid))
    assert plan.ldh >= (ROWS + 2) * (plan.tw + 2 * d)


def _conv2_window(plan, cmid, d, rng):
    """ROWS + 2 h1 rows (P1 x Cmid small integers) scattered into the
    window's positions through ``h1_offset``, everything else in the
    block's shared memory NaN: (the buffer, the rows)."""
    p1 = plan.tw + 2 * d
    buf = torch.full((plan.smem // 2,), float("nan"))
    rows = torch.from_numpy(rng.integers(0, 4, size=(ROWS + 2, p1, cmid)).astype(np.float32))
    pix, ch = torch.meshgrid(torch.arange(p1), torch.arange(cmid), indexing="ij")
    for k in range(ROWS + 2):
        buf[fused_block.h1_offset(k * p1 + pix, ch, plan.ldh)] = rows[k]
    return buf, rows


@pytest.mark.parametrize("n,h,w,cmid,d", CONV2_SHAPES)
def test_tc_conv2_tap_descriptors_read_the_shifted_h1(n, h, w, cmid, d):
    """Each tap's A descriptor (start ``conv2_a_start``, lbo 16 ldh bytes,
    sbo 128), read through ``descriptor_read``, holds for each output row q
    of the pass the h1 row q + ra shifted by cb * d pixels: tile row
    q P1 + p (p < TW) equals h1 row q + ra at pixel cb d + p, at the k16
    step's 16 channels."""
    plan = _tc_plan(n, h, w, cmid, d)
    buf, rows = _conv2_window(plan, cmid, d, np.random.default_rng(3))
    p1, m = plan.tw + 2 * d, fused_block.WGMMA_M
    for ra in range(3):
        for cb in range(3):
            for kc in range(0, cmid, fused_block.WGMMA_K):
                a = torch.cat([fused_block.descriptor_read(
                    buf, 2 * fused_block.conv2_a_start(kc, 0, t, ra, cb, d, p1, plan.ldh),
                    16 * plan.ldh, 128, m) for t in range(plan.mt2)])
                for q in range(ROWS):
                    want = rows[q + ra, cb * d:cb * d + plan.tw, kc:kc + 16]
                    assert torch.equal(a[q * p1:q * p1 + plan.tw], want)


@pytest.mark.parametrize("n,h,w,cmid,d", CONV2_SHAPES)
def test_tc_conv2_rows_past_tw_stay_in_shared_memory(n, h, w, cmid, d):
    """Every row of conv2's m64 tiles, those between and past its output
    rows included, reads inside the block's shared memory at every tap,
    k16 step and tile (the last tap's last channel block is the furthest),
    and no output row reads outside the P1 pixels conv1 wrote at its tap
    row's window position."""
    plan = _tc_plan(n, h, w, cmid, d)
    p1, m, k = plan.tw + 2 * d, fused_block.WGMMA_M, fused_block.WGMMA_K
    furthest = 0
    for ra in range(3):
        for cb in range(3):
            for kc in range(0, cmid, k):
                for t in range(plan.mt2):
                    start = fused_block.conv2_a_start(kc, 0, t, ra, cb, d, p1, plan.ldh)
                    # the core matrix of element (m-1, 15): k block 1, m block 7
                    last = 2 * start + 16 * plan.ldh + (m // 8 - 1) * 128 + 16 * 7 + 2 * 7
                    furthest = max(furthest, last + 2)
            for q in range(ROWS):  # output row q's pixels p < TW
                first, end = ra * p1 + cb * d + q * p1, ra * p1 + cb * d + q * p1 + plan.tw
                assert (q + ra) * p1 <= first and end <= (q + ra + 1) * p1
    assert furthest <= plan.smem
    # the same bound through the descriptor rule: nothing indexes past the buffer
    buf = torch.zeros(plan.smem // 2)
    start = fused_block.conv2_a_start(cmid - k, 0, plan.mt2 - 1, 2, 2, d, p1, plan.ldh)
    fused_block.descriptor_read(buf, 2 * start, 16 * plan.ldh, 128, m)


def _w_stage_buf(wt, i, kb, bn, n0, size):
    """Stage i (k rows [i kb, (i+1) kb), columns [n0, n0 + bn)) of the
    weight matrix ``wt`` in a weight buffer of ``size`` elements, by 16-byte
    pieces as ``stage_weights_tc`` copies them, the rest NaN."""
    buf = torch.full((size,), float("nan"))
    idx = torch.arange(kb * bn // 8)
    kr, c0 = fused_block.w_stage_piece(idx, bn)
    for e in range(8):
        buf[8 * idx + e] = wt[i * kb + kr, n0 + c0 + e]
    return buf


@pytest.mark.parametrize("n,h,w,cmid,d", CONV2_SHAPES)
def test_tc_conv2_emulation_equals_the_conv(n, h, w, cmid, d):
    """The nine shifted products: the window filled through ``h1_offset``
    (NaN elsewhere), w2 (HWIO as a (9 Cmid, Cmid) matrix) in stages of kb
    k-rows, each stage's A at its tap's position and shift, read back by
    the descriptors' lbo/sbo rule, multiplied per warpgroup and m64 tile
    and gathered through the fragment map, equal at tile rows q P1 + p the
    dilated 3x3 conv of h1 rows q .. q+2 exactly, for each of the pass's
    ROWS output rows q (small integers, exact in fp32)."""
    plan = _tc_plan(n, h, w, cmid, d)
    rng = np.random.default_rng(11)
    buf, rows = _conv2_window(plan, cmid, d, rng)
    p1 = plan.tw + 2 * d
    w2 = torch.from_numpy(rng.integers(-3, 4, size=(3, 3, cmid, cmid)).astype(np.float32))
    wt = w2.reshape(9 * cmid, cmid)
    tile = plan.conv2_tile(cmid)
    wgs = plan.threads // fused_block.WG_THREADS

    def a_start(i, s, t):
        tap, kc = divmod(i * plan.kb, cmid)
        ra, cb = divmod(tap, 3)
        return fused_block.conv2_a_start(kc, s, t, ra, cb, d, p1, plan.ldh)

    got = _emulate_tc(lambda i: buf, lambda i: _w_stage_buf(wt, i, plan.kb, cmid, 0, plan.wstage),
                      tile["stages"], plan.kb, cmid, tile["mt"], plan.ldh, a_start, wgs,
                      tile["nw"])
    # (1, Cmid, ROWS + 2, P1) rows of h1 → (1, Cmid, ROWS, TW): dilation d
    # along the row, the window's rows adjacent
    want = torch.nn.functional.conv2d(
        rows.double().permute(2, 0, 1)[None], w2.double().permute(3, 2, 0, 1),
        dilation=(1, d))[0]
    for q in range(ROWS):
        assert torch.equal(got[q * p1:q * p1 + plan.tw].double(), want[:, q].T)


@pytest.mark.parametrize("cin,cmid", [(64, 16), (384, 96), (1000, 256)])
def test_plan_tiles_rejects_unsupported_widths(cin, cmid):
    with pytest.raises(ValueError, match="Cmid"):
        plan_tiles(1, 9, 9, cin, cmid, 1, sm_count=132)
