"""Check the bf16 fused bottleneck's tiles on the card.

    python -m maxsquareloss_torch.experiments.tc_tiles

Two readings at the shapes the bf16 paths time: the 29 identity blocks of a
batch-2 1024x512 forward (the eval kernel) and the 58 of a train step, 4
images at 1280x640 and 4 at 1024x512 (the emit kernel), on bf16 inputs made
from a seed.

- tiles: ``plan_tiles`` takes the TW of least modelled cost at each shape.
  Here the kernel runs at every TW of ``tc_tws`` that ``tc_plan_at`` gives a
  plan for, the launch taking that plan in place of the planner's. Each
  result is held within 2 bf16 ulps of the plain version, with its share of
  elements bitwise equal to the planner's TW's; the TWs are timed in one
  order, then in the reverse one.
- epilogue: conv3's epilogue on the tc route reads the residual and stores
  out in the wgmma fragment's order, 4 bytes a thread.
  ``csrc/epilogue_probe.cu`` replays those accesses alone at the planner's
  grid, block and blocks an SM, beside the same work in 16-byte pieces
  (fragment, pieces, pieces, fragment), both held equal to relu(x + 1).

Prints the card's name and power limit, one JSON line a shape and reading,
then a summary: ms per eval forward and per train step at the planner's TW
and at the fastest TW of each shape, and the epilogue's two orders.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import subprocess

import torch

from maxsquareloss_torch.kernels import fused_block
from maxsquareloss_torch.kernels.build import CSRC, load, raise_on_error
from maxsquareloss_torch.kernels.fused_block import (
    fused_bottleneck,
    fused_bottleneck_emit,
    fused_bottleneck_emit_reference,
)
from maxsquareloss_torch.utils.device import resolve_device

BF16 = torch.bfloat16
# (layer, Cin, Cmid, dilation, blocks a forward): DeepLabV2-R101's identity blocks
LAYERS = (("layer1", 256, 64, 1, 2), ("layer2", 512, 128, 1, 3),
          ("layer3", 1024, 256, 2, 22), ("layer4", 2048, 512, 4, 2))
# (kernel, N, layer1's H x W at stride 4, layers 2-4's at stride 8): the eval
# forward, then the train step's source and target forwards
FORWARDS = (("eval", 2, (129, 257), (65, 129)),
            ("emit", 4, (161, 321), (81, 161)),
            ("emit", 4, (129, 257), (65, 129)))
BF16_ULPS = 2.0
REPS = 5


def shapes():
    """(kernel, layer, N, H, W, Cin, Cmid, d, blocks a forward)."""
    return [(kernel, name, n, *(hw4 if name == "layer1" else hw8), cin, cmid, d, per)
            for kernel, n, hw4, hw8 in FORWARDS for name, cin, cmid, d, per in LAYERS]


def _inputs(gen, n, h, w, cin, cmid):
    """x (post-ReLU, channels_last) and the HWIO kernels in bf16, the BN
    vectors fp32."""
    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = randn(n, h, w, cin).relu().permute(0, 3, 1, 2).to(BF16)
    ws = [randn(*shape, std=math.sqrt(2.0 / fan)).to(BF16)
          for shape, fan in (((1, 1, cin, cmid), cmid), ((3, 3, cmid, cmid), 9 * cmid),
                             ((1, 1, cmid, cin), cin))]
    bn = []
    for c, scale in ((cmid, None), (cmid, None), (cin, 0.1)):
        s = (torch.full((c,), scale) if scale is not None
             else torch.rand(c, generator=gen) + 0.5).cuda()
        bn += [s, randn(c, std=0.1)]
    return (x, *ws, *bn)


def _ulps(got, want) -> float:
    """|got - want| in bf16 ulps of want's largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    return err / 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)


def _ms(fn) -> float:
    """Mean ms a call over REPS calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


@contextlib.contextmanager
def _tiles_at(plan):
    """The kernel's launches take ``plan`` in place of the planner's."""
    planner = fused_block.plan_tiles
    fused_block.plan_tiles = lambda *args, **kwargs: plan
    try:
        yield
    finally:
        fused_block.plan_tiles = planner


def read_tiles(gen, sm, kernel, n, h, w, cin, cmid, d) -> dict:
    """The kernel at every TW with a plan: ulps, bitwise share against the
    planner's TW, ms (the mean of two turns in opposite orders)."""
    args = _inputs(gen, n, h, w, cin, cmid)
    fn = fused_bottleneck_emit if kernel == "emit" else fused_bottleneck
    want = fused_bottleneck_emit_reference(*args, d)
    if kernel == "eval":
        want = want[:1]
    chosen = fused_block.plan_tiles(n, h, w, cin, cmid, d, sm, BF16)
    plans = [p for tw in fused_block.tc_tws(cmid)
             if (p := fused_block.tc_plan_at(tw, n, h, w, cin, cmid, d, sm)) is not None]
    base = fn(*args, d)
    base = base if kernel == "emit" else (base,)
    tws = {}
    for plan in plans:
        with _tiles_at(plan):
            got = fn(*args, d)
        got = got if kernel == "emit" else (got,)
        ulps = max(_ulps(g, x) for g, x in zip(got, want))
        if not ulps <= BF16_ULPS:
            raise RuntimeError(f"{kernel} {(n, h, w, cin)} at TW {plan.tw}: {ulps} ulps")
        tws[plan.tw] = {"ulps": ulps, "ms": [],
                        "bitwise_share": min((g == b).float().mean().item()
                                             for g, b in zip(got, base))}
        del got
    for plan in plans + plans[::-1]:
        with _tiles_at(plan):
            tws[plan.tw]["ms"].append(_ms(lambda: fn(*args, d)))
    for v in tws.values():
        v["ms"] = sum(v["ms"]) / len(v["ms"])
    return {"chosen_tw": chosen.tw, "fastest_tw": min(tws, key=lambda tw: tws[tw]["ms"]),
            "tws": tws}


def read_epilogue(gen, sm, lib, n, h, w, cin, cmid, d) -> dict:
    """conv3's epilogue accesses alone, in fragment order and in 16-byte
    pieces, at the planner's grid, block and blocks an SM: ms of each."""
    plan = fused_block.plan_tiles(n, h, w, cin, cmid, d, sm, BF16)
    # the fused kernel's blocks an SM (as the planner counts them), held by
    # the dynamic shared memory each probe block asks for
    per_sm = max(1, min(256 // plan.threads,
                        fused_block.SMEM_SM // (plan.smem + fused_block.BLOCK_SMEM_RESERVED)))
    smem = fused_block.SMEM_SM // per_sm - fused_block.BLOCK_SMEM_RESERVED
    x = torch.randn(n, h, w, cin, generator=gen).to(BF16).cuda()
    want = (x + 1).relu()
    stream = torch.cuda.current_stream().cuda_stream

    def run(pieces):
        out = torch.empty_like(x)
        err = lib.msl_epilogue_probe(x.data_ptr(), out.data_ptr(), n, h, w, cin, d, plan.tw,
                                     plan.rs, plan.segs, plan.bn3, plan.mt3, plan.threads, smem,
                                     pieces, stream)
        raise_on_error(err, lib, "epilogue probe")
        return out

    for pieces in (0, 1):
        if not torch.equal(run(pieces), want):
            raise RuntimeError(f"epilogue probe ({'pieces' if pieces else 'fragment'}) "
                               f"at {(n, h, w, cin)} differs from relu(x + 1)")
    f1, p1, p2, f2 = (_ms(lambda: run(pieces)) for pieces in (0, 1, 1, 0))
    return {"blocks_an_sm": per_sm, "fragment_ms": (f1 + f2) / 2, "pieces_ms": (p1 + p2) / 2}


def main() -> dict:
    resolve_device()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    lib = load(CSRC / "epilogue_probe.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msl_epilogue_probe.argtypes = [p, p] + [i] * 13 + [p]
    lib.msl_epilogue_probe.restype = i
    gen = torch.Generator().manual_seed(11)
    keys = ("chosen", "fastest", "epilogue_fragment", "epilogue_pieces")
    summary = {kernel: dict.fromkeys(keys, 0.0) for kernel in ("eval", "emit")}
    for kernel, name, n, h, w, cin, cmid, d, per in shapes():
        row = {"kernel": kernel, "layer": name, "shape": [n, h, w, cin], "cmid": cmid,
               "dilation": d, "per_forward": per,
               **read_tiles(gen, sm, kernel, n, h, w, cin, cmid, d),
               **read_epilogue(gen, sm, lib, n, h, w, cin, cmid, d)}
        print(json.dumps(row), flush=True)
        total = summary[kernel]
        total["chosen"] += per * row["tws"][row["chosen_tw"]]["ms"]
        total["fastest"] += per * row["tws"][row["fastest_tw"]]["ms"]
        total["epilogue_fragment"] += per * row["fragment_ms"]
        total["epilogue_pieces"] += per * row["pieces_ms"]
        torch.cuda.empty_cache()
    summary["eval"]["per"] = "the 29 blocks of a batch-2 1024x512 forward"
    summary["emit"]["per"] = "the 58 blocks of a train step"
    print(json.dumps({"tc_tiles": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
