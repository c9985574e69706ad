"""Fused stride-1 identity bottleneck: the Hopper kernel, its wrappers,
its autograd Function and its plain PyTorch version.

Port of ``experiments/retired_pallas/fused_block.py``: ``_kernel_body`` /
``fused_bottleneck_padded`` (forward with ``emit=False``, the eval path)
and the training ``custom_vjp`` (``_fwd`` with ``emit=True``, ``_bwd``).
The kernel is CUDA C++ in ``csrc/fused_bottleneck.cu`` (its header note
gives the design and tile), built by ``kernels/build.py`` and called
through ``ctypes`` on PyTorch's current stream.

The wrappers take x as an NCHW tensor in ``torch.channels_last`` memory
format (physically NHWC), HWIO conv kernels as in the JAX package, and the
folded frozen-BN scale/bias vectors. On a CPU tensor they run the plain
version; on a CUDA tensor they launch the kernel or raise.

Types: x in float32 or bfloat16 (the compute dtype), the three kernels in
x's dtype, the BN vectors float32 (the frozen buffers). The kernel has an
instance for each of the two types (one source, two libraries: bf16 is
built with ``-DMSL_BF16``); any other type raises, naming it. In bf16 the
kernel and the plain version round where the Pallas body casts to the
compute dtype: each conv's fp32 sum, the BN's product and sum (the BN
vectors cast to bf16, as its ``_prep`` casts them), the residual add. The
bf16 instance runs conv1 and conv3 on the tensor cores (``wgmma``, the "tc"
route of ``plan_tiles``) and conv2 on the FMA loop; the fp32 instance runs
all three on the FMA loop. ``x_stage_offset``, ``w_stage_offset``,
``h2_offset``, ``epilogue_offset``, ``fragment_rows_cols`` and
``descriptor_read`` restate the tc route's shared-memory maps for the CPU
tests.

- ``fused_bottleneck``: out only (eval, no grad), through the custom op
  ``torch.ops.msl.fused_bottleneck`` (``torch.library``): its CUDA
  implementation launches the kernel or raises, its CPU implementation is
  the plain version, and its fake implementation gives ``torch.export`` a
  channels_last tensor of x's shape and dtype. ``torch.export`` cannot
  trace the ``ctypes`` call, so the op is what lets an exported program
  (``tools/export_inference.py``) launch the kernel; a process that loads
  such a program imports this module to register the op.
- ``fused_bottleneck_emit``: (out, h1, h2), the training forward.
- ``FusedBottleneckFn.apply``: differentiable in x and the three conv
  kernels; its backward is the adjoint chain of ``_bwd``
  (``bottleneck_backward``) as PyTorch ops over the saved x, h1, h2 and
  out, as the JAX package left it to XLA.

Each takes ``valid``, ``None`` or a contiguous (N, 2) int32 tensor on x's
device: the masked-canvas mode of the JAX package's ``_bottleneck(...,
mask=...)``. Image n's h1 is then zero outside its first ``valid[n, 0]``
rows and ``valid[n, 1]`` columns before conv2 reads it, and the emitted h1
is that masked h1, so the unchanged backward holds: h1 > 0 is exactly the
mask times the ReLU's derivative.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from maxsquareloss_torch.kernels.build import CSRC, load, raise_on_error

SOURCE = CSRC / "fused_bottleneck.cu"

K_STAGES = (16, 8)     # k rows per weight stage and channels per x stage (KB in the .cu)
PAD_BYTES = 16         # an x stage keeps KB elements + 16 bytes between two pixels
TILE_CHANNELS = 8      # channels per thread tile (kCh)
MAX_PIXEL_TILE = 8     # most pixels per thread tile the kernel is built for
# the kernel's instances: each type's nvcc defines and launch function
INSTANCES = {
    torch.float32: ((), "msl_fused_bottleneck_f32"),
    torch.bfloat16: (("-DMSL_BF16",), "msl_fused_bottleneck_bf16"),
}
# the tc route (the bf16 instance): conv1 and conv3 on wgmma
WGMMA_M = 64            # pixels (rows) of one wgmma tile
WGMMA_K = 16            # k of one bf16 wgmma
WG_THREADS = 128        # threads of a warpgroup
WGMMA_WIDTHS = (128, 64)  # columns of one warpgroup's wgmma (its NW)
# MT x NW: at most 64 fp32 accumulators a thread (128 spill beside the FMA
# loop's registers, ptxas on sm_90a, PERF.md)
MAX_ACC_COLS = 128
TC_MAX_TILES = 2        # m64 tiles a warpgroup holds at once (MT)
TC_STAGE_ROWS = (64, 32, 16)  # k rows of a conv1 / conv3 stage, deepest that fits
CORE = 8                # a core matrix: 8 rows x 8 bf16 (16 bytes)
EPI_COLS = 64           # conv3's epilogue: columns a warpgroup stages at a time (kEpiCols)
# plan_tiles' cost of a tc tile: conv2's FMA work on TW pixels plus conv1's
# and conv3's work on their m64 tiles' rows at TC_OVER_FMA times the FMA
# loop's rate, about 4 on an H100 at layer3's widths (PERF.md); every R101
# shape takes the same TW at any weight from 3 to 12
TC_OVER_FMA = 4
SMEM_BLOCK_MAX = 232448  # bytes of shared memory one block may use on sm_90
SMEM_SM = 233472         # bytes of shared memory per SM on sm_90
BLOCK_SMEM_RESERVED = 1024  # bytes the runtime reserves per resident block


def valid_mask(valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The 0/1 float (N, 1, H, W) mask of the per-image valid extents."""
    rows = torch.arange(h, device=valid.device) < valid[:, :1]
    cols = torch.arange(w, device=valid.device) < valid[:, 1:]
    return (rows[:, None, :, None] & cols[:, None, None, :]).float()


def fused_bottleneck_emit_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation,
                                    valid=None):
    """The plain version: ``F.conv2d`` chain + affine frozen BN + ReLU, h1
    masked by ``valid``; (out, h1, h2), each channels_last (h1, h2:
    (N, Cmid, H, W)). In x's dtype: the kernels and the BN vectors are cast
    to it, each conv sums in fp32 and rounds once, and every BN product and
    sum and the residual add is an op of that dtype, so in bf16 it rounds
    where the kernel does."""
    dt = x.dtype

    def conv(t, w, d=0):
        return F.conv2d(t, w.to(dt).permute(3, 2, 0, 1), padding=d, dilation=max(d, 1))

    def bn(y, s, b):
        return y * s.to(dt).view(1, -1, 1, 1) + b.to(dt).view(1, -1, 1, 1)

    h1 = F.relu(bn(conv(x, w1), s1, b1))
    if valid is not None:
        h1 = h1 * valid_mask(valid, *x.shape[2:]).to(dt)
    h2 = F.relu(bn(conv(h1, w2, dilation), s2, b2))
    y = F.relu(bn(conv(h2, w3), s3, b3) + x)
    return tuple(t.contiguous(memory_format=torch.channels_last) for t in (y, h1, h2))


def fused_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation,
                               valid=None):
    """The plain version of the block's output (differentiable)."""
    return fused_bottleneck_emit_reference(
        x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid)[0]


class TilePlan(NamedTuple):
    """One launch's tiles, as the kernel takes them (``plan_tiles``)."""

    tw: int       # output columns per block
    rs: int       # output rows per chain segment
    segs: int     # segments per chain
    threads: int  # threads per block
    smem: int     # bytes of dynamic shared memory, stages included
    bn3: int      # conv3's output columns per pass over h2
    px1: int      # pixels per thread tile in conv1, conv2, conv3 (fma; tc: px2)
    px2: int
    px3: int
    ldh: int      # elements between two pixels of h1 (and fma h2) in shared memory
    wstage: int   # elements of one weight stage buffer
    xs_px: int    # pixels of one x stage buffer (tc: its core-matrix pixel stride)
    kb: int       # k rows per weight stage, channels per x stage (tc: conv2's)
    kb1: int = 0  # tc: k rows of a conv1 stage and of a conv3 stage
    kb3: int = 0
    mt1: int = 0  # tc: m64 tiles of conv1 (tw + 2d pixels) and of conv3 (tw)
    mt3: int = 0
    h2p: int = 0  # tc: pixel stride of h2's core-matrix layout
    bn1: int = 0  # tc: conv1's output columns per pass over x
    route: str = "fma"  # conv1's and conv3's: "fma" (CUDA cores) or "tc" (wgmma)

    def launch_args(self) -> tuple[int, ...]:
        """The tile arguments of the launch function, in its order (on the
        fma route kb1 = kb3 = kb)."""
        kb13 = (self.kb1, self.kb3) if self.route == "tc" else (self.kb, self.kb)
        return (*self[:13], *kb13, self.mt1, self.mt3, self.h2p, self.bn1)

    def conv_routes(self) -> dict[str, str]:
        """What runs each conv: "wgmma" (tensor cores) or "fma" (the FMA
        loop on the CUDA cores)."""
        outer = "wgmma" if self.route == "tc" else "fma"
        return {"conv1": outer, "conv2": "fma", "conv3": outer}

    def flop_per_l2_weight_byte(self, itemsize: int = 4) -> float:
        """A block reads every weight once from L2 per output row of tw
        pixels: 2 FLOP per weight and pixel over ``itemsize`` bytes per
        weight."""
        return 2.0 * self.tw / itemsize

    def busy_threads(self, cmid: int, d: int) -> dict[str, int]:
        """Threads that own pixels in each conv (of ``threads``): a conv's
        threads are pixel tiles x channel groups of 8, and every tile that
        starts inside the conv's pixel row has work; on the tc route every
        warpgroup takes part in each wgmma of conv1 and conv3."""
        tiles12 = self.threads // (cmid // TILE_CHANNELS)
        conv2 = min(tiles12, math.ceil(self.tw / self.px2)) * (self.threads // tiles12)
        if self.route == "tc":
            return {"conv1": self.threads, "conv2": conv2, "conv3": self.threads}
        tiles3 = self.threads // (self.bn3 // TILE_CHANNELS)
        return {
            "conv1": min(tiles12, math.ceil((self.tw + 2 * d) / self.px1)) * (self.threads // tiles12),
            "conv2": conv2,
            "conv3": min(tiles3, math.ceil(self.tw / self.px3)) * (self.threads // tiles3),
        }

    def m_rows_used(self, d: int) -> dict[str, float]:
        """tc: the share of the m64 tiles' rows that are pixels of conv1's
        and conv3's rows (the rest are computed and dropped)."""
        if self.route != "tc":
            return {}
        return {"conv1": (self.tw + 2 * d) / (WGMMA_M * self.mt1),
                "conv3": self.tw / (WGMMA_M * self.mt3)}


def block_threads(cmid: int) -> int:
    """Threads per block: 256, or 128 where Cmid is 64 and 256 threads would
    leave 2-pixel tiles."""
    return 256 if cmid >= 128 else 128


def _stage_layout(tw: int, cin: int, cmid: int, d: int, kb: int):
    """The FMA route's (bn3, px1, px2, px3, ldh, wstage, xs_px, kb) for tw
    output columns a block and stages of kb k-rows, in fp32 elements, or None
    where the thread mapping does not exist. A conv's threads are T pixel tiles x BN/8 channel groups: conv1
    and conv2 take BN = Cmid in one pass (T = threads * 8 / Cmid), conv3 the
    widest BN3 that divides Cin and cuts tw evenly into tiles of at most 8
    pixels."""
    threads = block_threads(cmid)
    tiles = threads * TILE_CHANNELS // cmid
    px1 = math.ceil((tw + 2 * d) / tiles)
    if tw % tiles or tw // tiles > MAX_PIXEL_TILE or px1 > MAX_PIXEL_TILE:
        return None
    for bn3 in (512, 256, 128, 64):
        tiles3 = threads * TILE_CHANNELS // bn3
        if (cin % bn3 == 0 and threads % (bn3 // 4) == 0 and tw % tiles3 == 0
                and tw // tiles3 <= MAX_PIXEL_TILE):
            break
    else:
        return None
    # a warp that spans several pixel tiles reads several pixels at once:
    # 16 bytes of padding keep two neighbours off the same banks
    ldh = cmid + (PAD_BYTES // 4 if cmid // TILE_CHANNELS < 32 else 0)
    return (bn3, px1, tw // tiles, tw // tiles3, ldh, kb * max(cmid, bn3), tiles * px1, kb)


def smem_bytes(tw: int, cin: int, cmid: int, d: int, kb: int) -> int:
    """Shared memory of one block on the FMA route: 3 h1 rows of TW+2d
    pixels (pixel stride ldh; h2 takes the oldest row's slot), two weight
    stages of kb k-rows x the widest BN, and two x stages of conv1's pixels
    x kb channels (kb elements + 16 bytes a pixel), in fp32 elements."""
    _, _, _, _, ldh, wstage, xs_px, _ = _stage_layout(tw, cin, cmid, d, kb)
    return 4 * (ldh * 3 * (tw + 2 * d) + 2 * wstage + 2 * xs_px * (kb + PAD_BYTES // 4))


def x_stage_offset(pix, ch, xs_px: int):
    """tc: the element of an x stage that holds channel ``ch`` (of the
    stage's kb1) of pixel ``pix``: core matrices of 8 pixels x 8 channels,
    channel block c/8 of pixel p at 8 (xs_px (c/8) + p). A wgmma descriptor
    reads it with lbo = 16 xs_px bytes (k) and sbo = 128 (m)."""
    return CORE * (xs_px * (ch // CORE) + pix) + ch % CORE


def h2_offset(pix, ch, h2p: int):
    """tc: the element of h2's ring slot that holds channel ``ch`` of pixel
    ``pix`` (the x stage's layout with pixel stride h2p)."""
    return x_stage_offset(pix, ch, h2p)


def epilogue_offset(pix, col):
    """tc: the element of a warpgroup's conv3 epilogue tile (TW pixels x
    EPI_COLS columns, 128 bytes a pixel, in the x stages) that holds column
    ``col`` of pixel ``pix``: its 16-byte piece col/8 at piece (col/8) ^
    (pix%8) of the pixel's eight."""
    return EPI_COLS * pix + CORE * ((col // CORE) ^ (pix % CORE)) + col % CORE


def w_stage_offset(k, col, bn: int):
    """tc: the element of a weight stage (kb rows x bn columns) that holds
    W[k, col]: n-major core matrices of 8 k-rows x 8 columns, the bn/8 core
    matrices of one block of 8 k-rows side by side. Piece idx (16 bytes,
    8 columns of one k-row) lands at 8 idx; a descriptor reads it with lbo =
    16 bn bytes (k) and sbo = 128 (n)."""
    return CORE * (bn * (k // CORE) + CORE * (col // CORE) + k % CORE) + col % CORE


def w_stage_piece(idx, bn: int):
    """tc: the (k-row, first column) of the weight stage's 16-byte piece
    ``idx``, as ``stage_weights_tc`` copies it."""
    blk, blocks = idx // CORE, bn // CORE
    return CORE * (blk // blocks) + idx % CORE, CORE * (blk % blocks)


def fragment_rows_cols(nw: int):
    """tc: the (row, column) of the 64 x nw fp32 accumulator that thread t of
    a warpgroup holds in register i: i = 4j + 2h + e is row 16 (t/32) + 8h +
    (t%32)/4, column 8j + 2 (t%4) + e. Two (128, nw/2) int arrays."""
    t = torch.arange(WG_THREADS)[:, None]
    i = torch.arange(nw // 2)[None, :]
    rows = 16 * (t // 32) + 8 * ((i // 2) % 2) + (t % 32) // 4
    cols = 8 * (i // 4) + 2 * (t % 4) + i % 2
    return rows, cols


def descriptor_read(buf: torch.Tensor, start: int, lbo: int, sbo: int, rows: int,
                    mn_major: bool = False) -> torch.Tensor:
    """The (rows, 16) operand of one k16 step that a no-swizzle wgmma
    descriptor reads from ``buf`` (elements of 2 bytes; byte offsets as in
    the descriptor): the core matrix of element (m, kk) at start + (kk/8)
    lbo + (m/8) sbo, its
    16-byte rows along m for a k-major operand (A: m = pixels), element at
    16 (m%8) + 2 (kk%8) in it, or along k for an mn-major one (the
    transposed B: m = its columns), at 16 (kk%8) + 2 (m%8)."""
    m = torch.arange(rows)[:, None]
    kk = torch.arange(WGMMA_K)[None, :]
    row, col = (kk, m) if mn_major else (m, kk)
    byte = start + (kk // CORE) * lbo + (m // CORE) * sbo + 16 * (row % CORE) + 2 * (col % CORE)
    return buf[byte // 2]


def _tc_width(mt: int, n: int, wgs: int):
    """tc: the widest of WGMMA_WIDTHS a warpgroup takes over mt m64 tiles
    (MT x NW <= MAX_ACC_COLS) whose pass (wgs x NW columns) divides n."""
    return next((nw for nw in WGMMA_WIDTHS
                 if mt * nw <= MAX_ACC_COLS and n % (wgs * nw) == 0), None)


def _tc_layout(tw: int, cin: int, cmid: int, d: int, rows: int):
    """tc: (bn3, px2, ldh, wstage, xs_px, kb, kb1, kb3, mt1, mt3, h2p, bn1,
    smem) for tw output columns a block and conv1/conv3 stages of ``rows``
    k-rows, or None where the mapping does not exist. conv2 keeps the FMA
    loop's pixel tiles (tw = pixel tiles x px2, px2 <= 8) and stages of 16
    rows; conv1 runs over mt1 m64 tiles of the tw + 2d pixels, conv3 over
    mt3 tiles of tw, each in passes of bn1 / bn3 = warpgroups x the widest
    width that keeps 64 accumulators a thread. h1's pixel stride is padded
    by 16 bytes (bank-free 4-byte epilogue stores), the x stages' and h2's
    pixel strides are odd (bank-free stores into the core-matrix layout).
    Shared memory: the h1 ring, two weight stages, two x stages, and the
    rows past tw + 2d that conv1's last m64 tile reads behind the second x
    stage; conv3's epilogue stages its tiles (each warpgroup's tw x
    EPI_COLS) in the x stages."""
    threads = block_threads(cmid)
    wgs = threads // WG_THREADS
    tiles = threads * TILE_CHANNELS // cmid
    if tw % tiles or tw // tiles > MAX_PIXEL_TILE:
        return None
    p1 = tw + 2 * d
    mt1, mt3 = math.ceil(p1 / WGMMA_M), math.ceil(tw / WGMMA_M)
    nw1, nw3 = _tc_width(mt1, cmid, wgs), _tc_width(mt3, cin, wgs)
    if nw1 is None or nw3 is None or max(mt1, mt3) > TC_MAX_TILES:
        return None
    bn1, bn3 = wgs * nw1, wgs * nw3
    kb, kb1, kb3 = K_STAGES[0], rows, min(rows, cmid)
    ldh = cmid + PAD_BYTES // 2
    xs_px, h2p = p1 | 1, tw | 1
    if wgs * tw * EPI_COLS > 2 * xs_px * kb1:
        return None
    wstage = max(kb1 * bn1, kb3 * bn3, kb * cmid)
    overread = CORE * max(0, WGMMA_M * mt1 - xs_px)
    smem = 2 * (3 * p1 * ldh + 2 * wstage + 2 * xs_px * kb1 + overread)
    return (bn3, tw // tiles, ldh, wstage, xs_px, kb, kb1, kb3, mt1, mt3, h2p, bn1, smem)


def _tc_fit(tw: int, cin: int, cmid: int, d: int):
    """tc: the layout with the deepest stages that fits SMEM_BLOCK_MAX."""
    for rows in TC_STAGE_ROWS:
        layout = _tc_layout(tw, cin, cmid, d, rows)
        if layout is not None and layout[-1] <= SMEM_BLOCK_MAX:
            return layout
    return None


def tc_tws(cmid: int) -> range:
    """tc: the TWs conv2's FMA loop allows, multiples of its pixel tiles with
    at most 8 pixels a tile."""
    tiles = block_threads(cmid) * TILE_CHANNELS // cmid
    return range(tiles, MAX_PIXEL_TILE * tiles + 1, tiles)


def _tc_tw(w: int, cin: int, cmid: int, d: int) -> int:
    """tc: TW, the one of ``tc_tws`` with a layout that fits and the least
    cost over the width: strips x (conv2's FMA work on tw pixels + conv1's
    and conv3's work on their m64 tiles' rows over TC_OVER_FMA), so the m64
    tiles waste little; ties go to the wider strip."""
    best = None
    for tw in tc_tws(cmid):
        layout = _tc_fit(tw, cin, cmid, d)
        if layout is None:
            continue
        mt1, mt3 = layout[8], layout[9]
        cost = math.ceil(w / tw) * (9 * cmid * cmid * tw + cin * cmid * WGMMA_M * (mt1 + mt3)
                                    / TC_OVER_FMA)
        if best is None or cost <= best[0]:
            best = (cost, tw)
    if best is None:
        raise ValueError(f"fused bottleneck: Cin={cin}, Cmid={cmid}, d={d} fits no tile in "
                         f"{SMEM_BLOCK_MAX} B of shared memory")
    return best[1]


def _segments(n: int, h: int, d: int, ncols: int, threads: int, smem: int, sm_count: int):
    """(RS, S): output rows per chain segment and segments per chain. S
    trades conv1 recompute (2 extra h1 rows per segment) against filling the
    SMs: it minimises waves * (RS + 0.5)."""
    # the kernel takes up to 255 registers a thread: 256 threads an SM
    per_sm = max(1, min(256 // threads, SMEM_SM // (smem + BLOCK_SMEM_RESERVED)))
    slots = sm_count * per_sm
    chain = math.ceil(h / d)
    best = None
    for segs in range(1, chain + 1):
        rs = math.ceil(chain / segs)
        s = math.ceil(chain / rs)
        blocks = ncols * n * d * s
        cost = math.ceil(blocks / slots) * (rs + 0.5)
        if best is None or cost < best[0]:
            best = (cost, rs, s)
    return best[1], best[2]


def tc_plan_at(tw: int, n: int, h: int, w: int, cin: int, cmid: int, d: int,
               sm_count: int) -> TilePlan | None:
    """tc: the plan at tw output columns a block, with the deepest stages
    that fit, or None where no layout fits; ``plan_tiles`` takes it at the
    TW of least cost."""
    layout = _tc_fit(tw, cin, cmid, d)
    if layout is None:
        return None
    bn3, px2, ldh, wstage, xs_px, kb, kb1, kb3, mt1, mt3, h2p, bn1, smem = layout
    threads = block_threads(cmid)
    rs, s = _segments(n, h, d, math.ceil(w / tw), threads, smem, sm_count)
    return TilePlan(tw, rs, s, threads, smem, bn3, px2, px2, px2, ldh, wstage, xs_px, kb,
                    kb1, kb3, mt1, mt3, h2p, bn1, "tc")


def plan_tiles(n: int, h: int, w: int, cin: int, cmid: int, d: int, sm_count: int,
               dtype: torch.dtype = torch.float32) -> TilePlan:
    """Tile choice for one launch in ``dtype``: the single place for the
    kernel's shared-memory and thread arithmetic.

    threads: ``block_threads``. TW: columns per block, a multiple of the
    block's pixel tiles T = threads * 8 / Cmid, at most 64, the largest whose
    shared memory (``smem_bytes``, with stages of 8 k-rows) fits 232,448 B,
    then balanced over the width so the ragged last strip wastes little. The
    stages take 16 k-rows if that still fits (half the barriers: 11-15 %
    faster in the same loop on an H100, PERF.md). R101: layers 1-2 TW up to
    64, layer3 (Cmid 256, d 2) up to 56, layer4 (Cmid 512, d 4) 24, pinned
    there by its 3 x 32 x 2 KB ring. A block passes once over all weights
    per output row, so the tile gives TW / 2 FLOP per byte of L2 weight
    traffic. The pixels per thread tile (px1, px2, px3) give every thread a
    tile in every conv. RS: output rows per chain segment, S: segments per
    chain (a chain is one residue class of the rows mod d). S trades conv1
    recompute (2 extra h1 rows per segment) against filling the SMs: it
    minimises waves * (RS + 0.5).

    bf16 takes the tc route (``_tc_tw``, ``tc_plan_at``): conv1 and conv3
    on wgmma, whose m64 tiles, not conv1's pixel tiles, bound TW; conv2
    keeps the FMA loop's pixel tiles (TW up to 8 x its tiles) and stages of
    16 rows, conv1 and conv3 stream stages of up to 64 k-rows. R101 at 1024x512:
    layer1 TW 96, layer2 48, layer3 48, layer4 28.
    """
    threads = block_threads(cmid)
    if cmid not in (64, 128, 256, 512) or cin % 64:
        raise ValueError(
            f"fused bottleneck: the kernel takes Cmid 64, 128, 256 or 512 and "
            f"Cin a multiple of 64, got Cmid={cmid}, Cin={cin}"
        )
    if dtype == torch.bfloat16:
        return tc_plan_at(_tc_tw(w, cin, cmid, d), n, h, w, cin, cmid, d, sm_count)
    tiles = threads * TILE_CHANNELS // cmid

    def fits(tw, kb=K_STAGES[-1]):
        return (_stage_layout(tw, cin, cmid, d, kb) is not None
                and smem_bytes(tw, cin, cmid, d, kb) <= SMEM_BLOCK_MAX)

    tw_max = max((tw for tw in range(tiles, 65, tiles) if fits(tw)), default=None)
    if tw_max is None:
        raise ValueError(
            f"fused bottleneck: Cin={cin}, Cmid={cmid}, d={d} fits no tile in "
            f"{SMEM_BLOCK_MAX} B of shared memory"
        )
    ncols = math.ceil(w / tw_max)
    tw = math.ceil(math.ceil(w / ncols) / tiles) * tiles
    while not fits(tw):  # a narrower tile may lack a conv3 mapping: widen
        tw += tiles
    ncols = math.ceil(w / tw)
    kb = next(kb for kb in K_STAGES if fits(tw, kb))
    smem = smem_bytes(tw, cin, cmid, d, kb)
    rs, s = _segments(n, h, d, ncols, threads, smem, sm_count)
    return TilePlan(tw, rs, s, threads, smem, *_stage_layout(tw, cin, cmid, d, kb))


def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The built library of ``dtype``'s instance (its launch function's
    argtypes declared)."""
    defines, fn = INSTANCES[dtype]
    lib = load(SOURCE, defines)
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, fn).argtypes = [p] * 14 + [i] * 25 + [p]
    getattr(lib, fn).restype = i
    return lib


def _check(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid=None):
    if x.dim() != 4:
        raise ValueError(f"fused bottleneck: x must be 4-D NCHW, got {tuple(x.shape)}")
    n, cin, h, w = x.shape
    cmid = w1.shape[-1]
    if x.dtype not in INSTANCES:
        raise TypeError(f"fused bottleneck: x is {x.dtype}; the kernel has instances for "
                        f"{' and '.join(str(t) for t in INSTANCES)} only")
    want = {
        "w1": (w1, (1, 1, cin, cmid)), "w2": (w2, (3, 3, cmid, cmid)),
        "w3": (w3, (1, 1, cmid, cin)),
        "s1": (s1, (cmid,)), "b1": (b1, (cmid,)), "s2": (s2, (cmid,)),
        "b2": (b2, (cmid,)), "s3": (s3, (cin,)), "b3": (b3, (cin,)),
    }
    for name, (t, shape) in {"x": (x, tuple(x.shape)), **want}.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused bottleneck: {name} has shape {tuple(t.shape)}, expected {shape}")
        dtype = x.dtype if name[0] in "xw" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"fused bottleneck: {name} is {t.dtype}, expected {dtype} (x "
                            f"and the kernels in the compute dtype, the BN vectors float32)")
        if t.device != x.device:
            raise ValueError(f"fused bottleneck: {name} is on {t.device}, x on {x.device}")
        if name != "x" and not t.is_contiguous():
            raise ValueError(f"fused bottleneck: {name} must be contiguous")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused bottleneck: x must be channels_last contiguous")
    if dilation < 1:
        raise ValueError(f"fused bottleneck: dilation {dilation} < 1")
    if valid is None:
        return
    if tuple(valid.shape) != (n, 2) or valid.dtype != torch.int32:
        raise ValueError(f"fused bottleneck: valid must be ({n}, 2) int32, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != x.device or not valid.is_contiguous():
        raise ValueError(f"fused bottleneck: valid must be contiguous on {x.device}")
    # the extents are read back once per tensor, version and map size: a
    # canvas step hands the same two tensors to all its blocks, and a read
    # back per launch would stop the host at each of them (an inference
    # tensor keeps no version; the kernel reads no memory by the extents,
    # they only choose between h1 and zero)
    key = (None if valid.is_inference() else valid._version, h, w)
    if getattr(valid, "_msl_checked", None) != key:
        rows, cols = valid[:, 0], valid[:, 1]
        if bool(((rows < 1) | (rows > h) | (cols < 1) | (cols > w)).any()):
            raise ValueError(f"fused bottleneck: valid extents {valid.tolist()} outside "
                             f"[1, {h}] x [1, {w}]")
        valid._msl_checked = key


def _launch(args, dilation: int, emit: bool, valid=None):
    """One kernel launch on CUDA tensors: out, and h1/h2 with ``emit``."""
    x, w1 = args[0], args[1]
    n, cin, h, w = x.shape
    cmid = w1.shape[-1]
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("fused bottleneck: every tensor must be 16-byte aligned")
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = plan_tiles(n, h, w, cin, cmid, dilation, sm_count, x.dtype)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    hs = tuple(
        torch.empty((n, cmid, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
        for _ in range(2 if emit else 0)
    )
    lib = _library(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, INSTANCES[x.dtype][1])(
            *(t.data_ptr() for t in args), out.data_ptr(),
            *((t.data_ptr() for t in hs) if emit else (None, None)),
            None if valid is None else valid.data_ptr(),
            n, h, w, cin, cmid, dilation, *plan.launch_args(), stream,
        )
    raise_on_error(err, lib, "fused bottleneck")
    return (out, *hs)


def fused_bottleneck_emit(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation: int,
                          valid=None):
    """The training forward: (out, h1, h2) in one kernel, with
    h1 = relu(bn1(conv1 x)) (masked by ``valid``) and h2 = relu(bn2(conv2
    h1)), each (N, Cmid, H, W) channels_last; arguments as
    ``fused_bottleneck``. ``masked_launches`` counts the launches with
    ``valid``, ``bf16_launches`` those of the bf16 instance."""
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args, dilation, valid)
    if x.device.type == "cpu":
        return fused_bottleneck_emit_reference(*args, dilation, valid)
    if x.device.type != "cuda":
        raise ValueError(f"fused bottleneck: no kernel for device {x.device}")
    outs = _launch(args, dilation, emit=True, valid=valid)
    fused_bottleneck_emit.launches += 1
    fused_bottleneck_emit.masked_launches += valid is not None
    fused_bottleneck_emit.bf16_launches += x.dtype == torch.bfloat16
    return outs


fused_bottleneck_emit.launches = 0
fused_bottleneck_emit.masked_launches = 0
fused_bottleneck_emit.bf16_launches = 0


def bottleneck_backward(dy, x, h1, h2, out, w1, w2, w3, s1, s2, s3, dilation: int):
    """Adjoints of the block from its saved tensors (``_bwd`` of the JAX
    package's fused block): relu masks from out, h2 and h1, the BN scales,
    dw1/dw3 and the 1x1 adjoints as matrix products over the NHWC pixel
    rows, and the dilated 3x3's adjoints as one ``convolution_backward``.
    The saved tensors and the kernels are in the compute dtype (x's), the
    BN scales float32. As in ``_bwd``, the cotangents stay in the compute
    dtype, each product sums in fp32 (a BN scale multiplies in fp32 and
    rounds once), dw1 and dw3 are fp32 sums returned in fp32, and dw2 is
    the conv's weight gradient in the compute dtype (the JAX adjoint of a
    conv whose fp32 weight was cast), widened to fp32; in fp32 every cast
    is the identity. Returns (dx channels_last in the compute dtype, dw1,
    dw2, dw3 HWIO in fp32)."""
    n, cin, h, w = x.shape
    cmid = h1.shape[1]
    dt = x.dtype

    def rows(t):  # (N, C, H, W) → (N*H*W, C); a view for channels_last
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])

    dz3 = torch.where(rows(out) > 0, rows(dy), 0.0)         # relu' ⊙ dy
    dz3c = (dz3.float() * s3).to(dt)                        # through bn3's scale
    dw3 = rows(h2).float().T @ dz3c.float()                 # (Cmid, Cin)
    dh2 = dz3c @ w3.view(cmid, cin).T
    dacc = torch.where(rows(h2) > 0, dh2.float() * s2, 0.0).to(dt)
    dacc = dacc.view(n, h, w, cmid).permute(0, 3, 1, 2)     # channels_last NCHW
    w2_oihw = w2.permute(3, 2, 0, 1)
    dh1, dw2, _ = torch.ops.aten.convolution_backward(
        dacc, h1, w2_oihw, None, [1, 1], [dilation, dilation],
        [dilation, dilation], False, [0, 0], 1, [True, True, False],
    )
    dz1 = torch.where(rows(h1) > 0, rows(dh1).float() * s1, 0.0).to(dt)
    dw1 = rows(x).float().T @ dz1.float()                   # (Cin, Cmid)
    dx = dz1 @ w1.view(cin, cmid).T + dz3
    return (dx.view(n, h, w, cin).permute(0, 3, 1, 2), dw1.view(1, 1, cin, cmid),
            dw2.float().permute(2, 3, 1, 0), dw3.view(1, 1, cmid, cin))


class FusedBottleneckFn(torch.autograd.Function):
    """The identity block for training, with a gradient for x and the three
    HWIO kernels (frozen BN gets none); ``apply`` takes the arguments of
    ``fused_bottleneck``, ``valid`` positional, with the kernels in any
    float type (the fp32 parameters). Forward: ``fused_bottleneck_emit`` on
    kernels cast to x's dtype and made contiguous here (the TPU kernel's
    ``_prep``), so strided fp32 views of the convs' weights may come in;
    backward: ``bottleneck_backward`` over the saved x, h1 (masked), h2,
    out and cast kernels, whose fp32 weight gradients reach the parameters
    without a round trip through the compute dtype."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid=None):
        w1, w2, w3 = (w.to(x.dtype).contiguous() for w in (w1, w2, w3))
        out, h1, h2 = fused_bottleneck_emit(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation,
                                            valid)
        ctx.save_for_backward(x, h1, h2, out, w1, w2, w3, s1, s2, s3)
        ctx.dilation = dilation
        return out

    @staticmethod
    def backward(ctx, dy):
        grads = bottleneck_backward(dy, *ctx.saved_tensors, ctx.dilation)
        return (*grads, *(None,) * 8)


FUSED_BOTTLENECK_SCHEMA = (
    "(Tensor x, Tensor w1, Tensor w2, Tensor w3, Tensor s1, Tensor b1, Tensor s2, Tensor b2, "
    "Tensor s3, Tensor b3, int dilation, Tensor? valid=None) -> Tensor")


@torch.library.custom_op("msl::fused_bottleneck", mutates_args=(),
                         schema=FUSED_BOTTLENECK_SCHEMA)
def _fused_bottleneck_op(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid=None):
    raise ValueError(f"fused bottleneck: no kernel for device {x.device}")


@_fused_bottleneck_op.register_kernel("cpu")
def _fused_bottleneck_cpu(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid=None):
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args, dilation, valid)
    return fused_bottleneck_reference(*args, dilation, valid)


@_fused_bottleneck_op.register_kernel("cuda")
def _fused_bottleneck_cuda(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid=None):
    args = (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    _check(*args, dilation, valid)
    (out,) = _launch(args, dilation, emit=False, valid=valid)
    fused_bottleneck.launches += 1
    fused_bottleneck.masked_launches += valid is not None
    fused_bottleneck.bf16_launches += x.dtype == torch.bfloat16
    return out


@_fused_bottleneck_op.register_fake
def _fused_bottleneck_fake(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid=None):
    return torch.empty_like(x, memory_format=torch.channels_last)


def fused_bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation: int, valid=None):
    """Stride-1 identity-residual bottleneck in one kernel (eval: no h1/h2),
    as the custom op ``torch.ops.msl.fused_bottleneck``.

    Args:
      x: (N, Cin, H, W) float32 or bfloat16, ``torch.channels_last``
        contiguous.
      w1/w2/w3: HWIO kernels (1,1,Cin,Cmid), (3,3,Cmid,Cmid), (1,1,Cmid,Cin)
        in x's dtype.
      s1..b3: folded frozen-BN scale/bias vectors, float32.
      dilation: conv2's dilation (and zero padding).
      valid: None, or (N, 2) int32 valid (rows, columns) of each image on a
        canvas: h1 is zero past them before conv2 (``masked_launches``
        counts these launches; ``bf16_launches`` counts the bf16 instance's).
    Returns:
      (N, Cin, H, W) in x's dtype, channels_last. ``launches`` counts the
      kernel's launches, from a live graph or an exported program alike.
    """
    return torch.ops.msl.fused_bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, dilation, valid)


fused_bottleneck.launches = 0
fused_bottleneck.masked_launches = 0
fused_bottleneck.bf16_launches = 0
