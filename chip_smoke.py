#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:
  1. environment: the card (as nvidia-smi reports name and power limit),
     torch and CUDA versions; TF32 is switched off for cuDNN and matmul so
     every plain fp32 reference runs in full fp32;
  2. build: compiles every kernel source of the port from
     ``maxsquareloss_torch/csrc``, one ``nvcc`` per source, all at once;
  3. kernels: the eval bottleneck against its plain PyTorch version at every shape
     the main path gives it (rtol = atol = 1e-4: fp32 sums over up to 4608
     terms in another order); the eval shapes are also timed with CUDA
     events in the order plain, kernel, kernel, plain, beside their bound
     (the larger of FLOPs over 67 TFLOP/s fp32 and bytes over 3.35 TB/s).
     Every shape's line carries the planner's tile, its shared memory with
     the weight and x stages, the FLOP per byte of L2 weight traffic and
     the threads that own pixels in each conv; at layer3 a second call must
     give the same bits;
  4. slice: full-width DeepLabV2-R101 (seeded random weights). The kernel
     path's logits and predict's trainIds must agree with the plain path's
     on the same card. Then the main path, each drive repeated REPS times:
     ``evaluate`` (1024x512 images, 1024x512 labels, then 2048x1024 labels
     with the auto-chunked tail) and ``make_predict_fn`` (scales 0.75,1.0 +
     flip). The kernel launch count must rise by 29 per forward, every
     shape the kernel saw must be one phase 3 checked, and the confusion
     matrix must count every valid label pixel;
  5. profile: device time by kernel name over one eval batch (torch.profiler)
     and the device's idle share;
  6. train kernels: the fused IW and plain max-square losses, forward and
     backward, against their plain versions at the UDA step's
     (4, 512, 1024, 19), a ragged (1, 37, 53, 19) and (40, 9, 11, 19), whose
     images are smaller than a tile, with exact ties
     between two classes and a degenerate class weight of 1.0 (forward rel
     1e-4, grads atol 1e-5 and 1e-4 of the largest), each bitwise equal on
     a second call; the emit bottleneck's out, h1, h2 at the 8 training
     shapes (rtol = atol = 1e-4; tile report and bitwise repeat as in
     phase 3) and its autograd backward against the
     plain chain's at one shape per layer (relative L2: the adjoint chain
     on the same saved tensors <= 1e-4, the whole kernel path <= 1e-3, with
     the ReLU-mask disagreements between the two forwards); timed;
  7. train: full-width R101 UDA steps (IW_maxsquare with --iw_hist argmax,
     multi-level, 4 source images at 1280x640 and 4 target images at
     1024x512). One kernel-path
     step against one plain-path step from the same weights (loss and
     metrics rel 1e-4, every parameter's change relative L2 <= 1e-3); then
     2 warm-up and REPS timed steps (steps/s and images/s, median, min,
     max; peak memory), one maxsquare step; the emit kernel launches 58
     times a step at checked shapes, each loss kernel once a direction;
  8. train profile: device time by kernel name over one train step;
  9. probe: the matmul-chain calibration kernel against its plain version
     at the reference's defaults (M 1728, K 1024, N 256, 72 cells, chain 3),
     at the layer-4 widths (K 2048, N 512), at a ragged M, at fewer rows than
     a row tile and at one cell, each in
     bf16 -> bf16, bf16 -> fp32 and fp32 -> fp32 (max abs error over max
     |out|: fp32 1e-4, bf16 2e-2), bitwise equal on a second call, each
     line with the planner's route, row tile, weight ring, bytes in flight
     and FLOP per L2 weight byte; timed beside its bound, the plain version and the same chain as batched
     torch.matmul; then the entry point ``experiments.bench_matmul`` once,
     counted;
 10. trainer: ``UDATrainer`` at the train phase's configuration over
     ``SegDataLoader``s of in-memory data (8 workers): 6 iterations, a
     checkpoint every 3, a validation over 2 batches of 2 at 1024x512. The
     emit kernel launches 58 times an iteration and each loss kernel once a
     direction, the eval kernel 29 times a validation batch; the latest
     checkpoint loads equal to the live model; a second trainer resumes the
     iteration-3 checkpoint with --continue_training and repeats the
     losses of iterations 4-6 (relative 1e-4). Reports steps/s beside the
     bare step's, the idle share over two iterations, peak memory, and the
     checkpoint's save time and size;
 11. cli: ``tools.solve_gta5`` for 2 iterations on a small on-disk
     domain-shift pair at 128x256 (PIL is required: the run fails without it);
 12. serving_cli: ``tools.evaluate`` on that run's ``checkpoint_latest.pth``
     (single scale: mIoU within 1e-4 of ``evaluate`` on the trainer's model
     in this process; scales 0.75,1.0 + flip; --full_res_labels) and
     ``tools.predict`` with scales 0.75,1.0 + flip (a PNG pair per image,
     trainIds in 0..18, the first image's equal to ``make_predict_fn`` on
     99.9 % of the pixels), each with its exact eval-kernel launch count;
 13. crosscity: ``tools.solve_crosscity`` for 2 iterations, Cityscapes → a
     synthetic NTHU Rio at 128x256, 13 classes;
 14. bench: ``maxsquareloss_torch.bench`` in this process in modes uda and
     source (5 timed steps after 2), infer at 1024x512 with 1024x512 and
     1024x2048 labels, and e2e at the protocol's disk sizes over 16 images
     a domain for one epoch a leg; each prints its JSON line;
 15. efficacy: the adaptation-efficacy gate at ``tests/test_adaptation.py``'s
     protocol (seed 0, --blocks 1,1,2,1, 128x64, batch 8, 300 source and
     200 UDA iterations, lambda 64): IW_maxsquare must beat the
     lambda_target 0 control and source-only by more than 0.03 mIoU.
     Phases 11-15 record every kernel launch's shape; each shape no earlier
     phase checked is then held against the plain version (tolerances of
     phases 3 and 6).
All full-width phases run R101 (blocks 3,4,23,3) in fp32 with TF32 off.
Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, when CUDA is absent or a check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.data.loader import SegDataLoader
from maxsquareloss_torch.data.synthetic import SyntheticSegDataset, uint8_batches
from maxsquareloss_torch.kernels import build as kernel_build
from maxsquareloss_torch.experiments import bench_matmul
from maxsquareloss_torch.kernels import fused_block, fused_loss, matmul_probe
from maxsquareloss_torch.kernels.fused_block import (
    FusedBottleneckFn,
    bottleneck_backward,
    fused_bottleneck,
    fused_bottleneck_emit,
    fused_bottleneck_emit_reference,
    fused_bottleneck_reference,
)
from maxsquareloss_torch.kernels.fused_loss import (
    fused_iw_max_square_loss,
    fused_iw_max_square_loss_reference,
    fused_max_square_loss,
    fused_max_square_loss_reference,
)
from maxsquareloss_torch.kernels.matmul_probe import matmul_chain, matmul_chain_plain
from maxsquareloss_torch.models.deeplabv2 import (
    Bottleneck,
    DeepLabV2,
    init_deeplabv2,
    valid_logits_hw,
)
from maxsquareloss_torch.ops.histogram import class_histogram, iw_class_weights
from maxsquareloss_torch.predict import make_predict_fn
from maxsquareloss_torch.train import checkpoint as ckpt_lib
from maxsquareloss_torch.train import steps as train_steps
from maxsquareloss_torch.train.evaluator import evaluate
from maxsquareloss_torch.train.steps import (
    _prepare_inputs,
    make_train_state,
    make_uda_train_step,
    model_config,
)
from maxsquareloss_torch.train.uda_trainer import UDATrainer

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 dense on the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
RTOL = ATOL = 1e-4
IMG_HW = (512, 1024)  # Cityscapes eval protocol base size (H, W)
BATCH = 2
PREDICT_SCALES = (0.75, 1.0)  # with flip, which doubles the batch
REPS = 5  # timed repeats of each main-path drive
# (layer, Cin, Cmid, dilation, identity blocks per R101 forward)
LAYERS = (
    ("layer1", 256, 64, 1, 2),
    ("layer2", 512, 128, 1, 3),
    ("layer3", 1024, 256, 2, 22),
    ("layer4", 2048, 512, 4, 2),
)


def block_shapes(n: int, img_hw: tuple[int, int]) -> list[tuple]:
    """(layer, N, H, W, Cin, Cmid, dilation, per forward) of the identity
    blocks of one forward: layer1 at the stem's stride 4, the rest at 8."""

    def os4(v: int) -> int:  # conv 7x7/2 p3 → ceil-mode maxpool 3x3/2 p1
        return math.ceil(((v + 2 * 3 - 7) // 2 + 1 - 1) / 2) + 1

    hw8 = valid_logits_hw(img_hw)
    hw4 = (os4(img_hw[0]), os4(img_hw[1]))
    return [(name, n, *(hw4 if name == "layer1" else hw8), cin, cmid, d, per_fwd)
            for name, cin, cmid, d, per_fwd in LAYERS]


# timed: one batch-2 forward at 1024x512; checked only: predict's TTA forwards
BLOCK_SHAPES = block_shapes(BATCH, IMG_HW)
TTA_SHAPES = [s for scale in PREDICT_SCALES for s in block_shapes(
    2 * BATCH, (max(1, round(IMG_HW[0] * scale)), max(1, round(IMG_HW[1] * scale))))]

# the UDA train step (TrainConfig defaults: 4 source images at 1280x640
# and 4 target images at 1024x512, (H, W) below) with --iw_hist argmax:
# from random weights the guidance label keeps ~0.2 % of the pixels, most
# classes take the degenerate IW weight 1.0 and the default diverges to NaN
# by the third step (the reference's multi-arm collapse, BASELINE.md);
# counting the argmax keeps the weights at their ~1/total scale and runs
# the same kernels
TRAIN_CFG = TrainConfig(iw_hist="argmax")
TRAIN_BATCH = TRAIN_CFG.batch_size
SRC_HW = TRAIN_CFG.crop_size[::-1]
TGT_HW = TRAIN_CFG.target_crop_size[::-1]
TRAIN_SHAPES = block_shapes(TRAIN_BATCH, SRC_HW) + block_shapes(TRAIN_BATCH, TGT_HW)
# the main path's; one whose pixel count is no multiple of the 256-pixel tile;
# one with images smaller than a tile, over two blocks (40 * 99 pixels)
LOSS_SHAPES = ((TRAIN_BATCH, *TGT_HW), (1, 37, 53), (40, 9, 11))
NUM_CLASSES = TRAIN_CFG.num_classes
WARMUP_STEPS = 2
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL_MAX = 1e-4, 1e-5, 1e-4
# the block backward, relative L2 per tensor: the adjoint chain on the
# plain forward's saved tensors 1e-4; the whole kernel path 1e-3, since a
# pre-activation within fp32 rounding of 0 takes the other ReLU mask in the
# kernel's forward than in cuDNN's and passes a whole gradient element
BACKWARD_RTOL_L2, BACKWARD_E2E_RTOL_L2 = 1e-4, 1e-3
STEP_RTOL, STEP_PARAM_RTOL_L2 = 1e-4, 1e-3
# the trainer: 6 iterations, a checkpoint at 3, a resume that runs 4-6 again
# and matches the first run's losses to relative 1e-4 (cuDNN's backward is
# left nondeterministic, as in training); validation over 2 batches of 2
TRAINER_ITERS, TRAINER_SAVE_ITER, TRAINER_RESUME_RTOL = 6, 3, 1e-4
VAL_BATCH = 2
# the CLI phases: full-width R101 on small on-disk sets at 128x256
CLI_SIZE = ["--base_size", "256,128", "--crop_size", "256,128"]
CLI_COMMON = ["--batch_size", "2", "--num_workers", "4", "--tqdm", "false"]

# the launch count of every kernel, by the name it has in the kernels line
COUNTERS = {
    "fused_bottleneck": (fused_bottleneck, "launches"),
    "fused_bottleneck_emit": (fused_bottleneck_emit, "launches"),
    "fused_iw_max_square_loss": (fused_iw_max_square_loss, "launches"),
    "fused_iw_max_square_loss_backward": (fused_iw_max_square_loss, "backward_launches"),
    "fused_max_square_loss": (fused_max_square_loss, "launches"),
    "fused_max_square_loss_backward": (fused_max_square_loss, "backward_launches"),
    "matmul_probe": (matmul_chain, "launches"),
}

# the calibration probe: (name, M, K, N, cells, chain) at the reference's
# defaults, at the layer-4 widths, with a ragged M (not a multiple of any
# row tile) over a few cells, with fewer rows than one row tile, and with one
# cell; each in bf16 -> bf16, bf16 -> fp32, fp32 -> fp32
PROBE_SHAPES = (
    ("defaults", 1728, 1024, 256, 72, 3),
    ("layer4", 1728, 2048, 512, 72, 3),
    ("ragged", 1000, 1024, 256, 3, 3),
    ("one_tile", 13, 1024, 256, 2, 3),
    ("one_cell", 1728, 1024, 256, 1, 3),
)
PROBE_TIMED = ("defaults", "layer4")
BF16, F32 = torch.bfloat16, torch.float32
PROBE_TYPES = ((BF16, BF16), (BF16, F32), (F32, F32))
# max abs error over max |out|: fp32 sums in another order; in bf16 a link's
# output rounded to bf16 after a sum in another order may move by one ulp
PROBE_TOL = {F32: 1e-4, BF16: 2e-2}


def zero_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms_median(fn, reps: int, windows: int = 5) -> float:
    """The median of ``windows`` timings of ``reps`` calls each: for kernels
    of tens of microseconds, where one stall of the host inside a window
    would double its reading."""
    return statistics.median(time_ms(fn, reps) for _ in range(windows))


def phase_environment() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    env = {
        "phase": "environment", "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(env)
    return env


def phase_build() -> None:
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    sources = (fused_block.SOURCE, fused_loss.SOURCE, matmul_probe.SOURCE)

    def timed_build(source):
        lib = kernel_build.build(source)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed_build, sources))
    for module in (fused_block, fused_loss, matmul_probe):
        module._library()
    emit({"phase": "build", "libraries": [lib.name for lib, _ in built],
          "seconds_by_source": {src.name: sec for src, (_, sec) in zip(sources, built)},
          "seconds": time.perf_counter() - t0})


def _block_inputs(gen, n, h, w, cin, cmid):
    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = randn(n, h, w, cin).relu().permute(0, 3, 1, 2)  # post-ReLU, channels_last
    w1 = randn(1, 1, cin, cmid, std=math.sqrt(2.0 / cmid))
    w2 = randn(3, 3, cmid, cmid, std=math.sqrt(2.0 / (9 * cmid)))
    w3 = randn(1, 1, cmid, cin, std=math.sqrt(2.0 / cin))
    bn = []
    for c, scale in ((cmid, None), (cmid, None), (cin, 0.1)):
        s = (torch.full((c,), scale) if scale is not None
             else torch.rand(c, generator=gen) + 0.5).cuda()
        bn += [s, randn(c, std=0.1)]
    return (x, w1, w2, w3, *bn)


def _tile_report(n, h, w, cin, cmid, d) -> dict:
    """The planner's tile for one shape: its fields, the shared memory with
    the weight and x stages, the FLOP per byte of L2 weight traffic (a block
    reads every weight once per output row of its strip) and the threads
    that own pixels in each conv."""
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused_block.plan_tiles(n, h, w, cin, cmid, d, sm_count)
    return {"tile": plan._asdict(), "smem_bytes_with_stages": plan.smem,
            "flop_per_l2_weight_byte": plan.flop_per_l2_weight_byte,
            "busy_threads": plan.busy_threads(cmid, d)}


def _hold_block(gen, name, n, h, w, cin, cmid, d) -> tuple[tuple, dict]:
    """One shape's inputs, and the kernel's errors against the plain version."""
    args = _block_inputs(gen, n, h, w, cin, cmid)
    got = fused_bottleneck(*args, d)
    want = fused_bottleneck_reference(*args, d)
    torch.cuda.synchronize()
    err = (got - want).abs()
    worst = (err / (ATOL + RTOL * want.abs())).max().item()
    max_abs = err.max().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    check(worst <= 1.0, f"{name}: kernel vs plain {max_abs:.3g} abs, {worst:.3g}x the tolerance")
    return args, {
        "layer": name, "shape": [n, h, w, cin], "cmid": cmid, "dilation": d,
        **_tile_report(n, h, w, cin, cmid, d),
        "max_abs_err": max_abs,
        "max_rel_err": (err / want.abs().clamp_min(ATOL)).max().item(),
        "max_abs_ref": want.abs().max().item(),
        "worst_over_tol": worst,
    }


def phase_kernels() -> tuple[set, dict]:
    """fused_bottleneck against its plain version at every shape of the main
    path, timed at the eval shapes. Returns the set of (N, H, W, Cin, Cmid,
    d) that were checked, and the kernels-line entry."""
    gen = torch.Generator().manual_seed(0)
    checked = set()
    tta_worst = 0.0
    for name, n, h, w, cin, cmid, d, _ in TTA_SHAPES:
        args, row = _hold_block(gen, name, n, h, w, cin, cmid, d)
        emit({"phase": "kernel_check", "kernel": "fused_bottleneck", **row})
        checked.add((n, h, w, cin, cmid, d))
        tta_worst = max(tta_worst, row["max_abs_err"])
        del args
    rows = []
    for name, n, h, w, cin, cmid, d, per_fwd in BLOCK_SHAPES:
        args, row = _hold_block(gen, name, n, h, w, cin, cmid, d)
        checked.add((n, h, w, cin, cmid, d))
        if name == "layer3":  # no atomics: a second call gives the same bits
            check(torch.equal(fused_bottleneck(*args, d), fused_bottleneck(*args, d)),
                  f"{name}: two calls differ (not bitwise deterministic)")
            row["bitwise_repeatable"] = True
        reps = 5

        def kernel():
            return fused_bottleneck(*args, d)

        def plain():
            return fused_bottleneck_reference(*args, d)

        p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kernel, kernel, plain))
        torch.backends.cudnn.allow_tf32 = True  # cuDNN at PyTorch's defaults
        lib_ms = time_ms(plain, reps)
        torch.backends.cudnn.allow_tf32 = False
        flops = 2 * n * h * w * (2 * cin * cmid + 9 * cmid * cmid)
        nbytes = 4 * (2 * n * h * w * cin + 2 * cin * cmid + 9 * cmid * cmid
                      + 4 * cmid + 2 * cin)
        bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row.update({
            "per_forward": per_fwd,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            "tflops": flops / ((k1 + k2) / 2) / 1e9,
        })
        emit({"phase": "kernel", "kernel": "fused_bottleneck", **row})
        rows.append(row)
        del args
    torch.cuda.empty_cache()

    def per_forward(key):
        return sum(r[key] * r["per_forward"] for r in rows)

    return checked, {
        "name": "fused_bottleneck",
        "route": "cuda",
        "source": "maxsquareloss_torch/csrc/fused_bottleneck.cu",
        "replaces": "experiments/retired_pallas/fused_block.py:153",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(tta_worst, *(r["max_abs_err"] for r in rows)),
        # times and bound: the 29 identity blocks of one batch-2 forward
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
        "library_ms": per_forward("library_ms"),
        "library": "the plain F.conv2d chain with cuDNN at PyTorch defaults (TF32 convs)",
        "shapes": rows,
    }


def phase_slice(checked: set) -> dict:
    """``checked``: the (N, H, W, Cin, Cmid, d) shapes phase 3 held the
    kernel at; every shape the main path launches it at must be one."""
    cfg = TrainConfig(eval_h_chunk=-1)  # R101, 19 classes, multi-level, auto chunk
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device="cuda")
    n_ident = sum(b.fusable for layer in (model.layer1, model.layer2, model.layer3,
                                          model.layer4) for b in layer)
    check(n_ident == 29, f"{n_ident} identity blocks, expected 29")
    ds = SyntheticSegDataset(length=3 * BATCH, hw=IMG_HW, seed=1)
    batches = list(uint8_batches(ds, BATCH))

    # kernel path vs plain path on the same card, same weights: the logits
    # of one batch, and predict's trainIds at the main path's TTA
    plain = DeepLabV2(model.cfg, plain_blocks=True).to(
        device="cuda", memory_format=torch.channels_last).eval()
    plain.load_state_dict(model.state_dict())
    x0 = torch.from_numpy(batches[0][0]).cuda()
    with torch.inference_mode():
        xn, _ = _prepare_inputs(x0, None, cfg)
        aux_k, main_k = model(xn)
        aux_p, main_p = plain(xn)
    pred_k, pred_p = (make_predict_fn(cfg, m, PREDICT_SCALES, flip=True, out_hw=IMG_HW)(x0)
                      for m in (model, plain))
    del plain
    scale = main_p.abs().max().item()
    dmax = (main_k - main_p).abs().max().item()
    agree = (main_k.argmax(-1) == main_p.argmax(-1)).float().mean().item()
    pred_agree = (pred_k == pred_p).float().mean().item()
    check(main_k.shape == (BATCH, *valid_logits_hw(IMG_HW), 19), f"logits shape {tuple(main_k.shape)}")
    check(bool(torch.isfinite(main_k).all() and torch.isfinite(aux_k).all()), "non-finite logits")
    check(dmax <= 1e-3 * scale, f"kernel vs plain logits differ by {dmax:.3g} (max |logit| {scale:.3g})")
    check(agree >= 0.999, f"argmax agrees on {agree:.5f} of pixels")
    check(pred_agree >= 0.999, f"predict trainIds agree on {pred_agree:.5f} of pixels")
    emit({"phase": "slice_parity", "max_abs_logit_diff": dmax, "max_abs_logit": scale,
          "aux_max_abs_diff": (aux_k - aux_p).abs().max().item(),
          "argmax_agreement": agree, "predict_agreement": pred_agree})
    del aux_k, main_k, aux_p, main_p, pred_k, pred_p

    # record the shape of every launch on the main path
    seen = set()

    def recording_kernel(x, *args):
        n, cin, h, w = x.shape
        seen.add((n, h, w, cin, args[0].shape[-1], args[-1]))
        return fused_bottleneck(x, *args)

    model.block_fn = recording_kernel

    # the main path, counted: every launch from here to the end is the path's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()

    def drive(name, fn, images, forwards, valid_pixels=None):
        """REPS timed calls of ``fn``; images/s as median, min and max."""
        secs = []
        for _ in range(REPS):
            before = fused_bottleneck.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = fused_bottleneck.launches - before
            check(launches == 29 * forwards,
                  f"{name}: {launches} kernel launches, expected {29 * forwards}")
            if valid_pixels is not None:
                total = int(out["_eval"].confusion_matrix.sum())
                check(total == valid_pixels, f"{name}: CM counts {total} of {valid_pixels} valid pixels")
                check(math.isfinite(out["MIoU"]), f"{name}: mIoU {out['MIoU']}")
        rates = sorted(images / s for s in secs)
        run = {"phase": "slice", "run": name, "images": images, "forwards": forwards,
               "reps": REPS, "kernel_launches_per_rep": launches, "seconds": secs,
               "images_per_s_median": statistics.median(rates),
               "images_per_s_min": rates[0], "images_per_s_max": rates[-1]}
        if valid_pixels is not None:
            run.update({"MIoU": out["MIoU"], "PA": out["PA"], "cm_total": total})
        emit(run)
        return out

    valid = sum(int((y >= 0).sum()) for _, y, _ in batches)
    drive("evaluate_1024x512", lambda: evaluate(model, cfg, batches), len(ds), len(batches), valid)
    full = list(uint8_batches(SyntheticSegDataset(length=BATCH, hw=IMG_HW, seed=2), BATCH,
                              label_hw=(2 * IMG_HW[0], 2 * IMG_HW[1])))
    drive("evaluate_fullres_labels_chunked", lambda: evaluate(model, cfg, full), BATCH, 1,
          sum(int((y >= 0).sum()) for _, y, _ in full))
    predict = make_predict_fn(cfg, model, scales=PREDICT_SCALES, flip=True, out_hw=IMG_HW)
    pred = drive("predict_ms_flip", lambda: predict(x0), BATCH, len(PREDICT_SCALES))
    check(pred.shape == (BATCH, *IMG_HW) and pred.dtype == torch.int32, f"predict {tuple(pred.shape)}")
    check(bool(((pred >= 0) & (pred < 19)).all()), "predict: trainIds out of range")
    launches = fused_bottleneck.launches
    others = {k: v for k, v in read_counts().items() if k != "fused_bottleneck" and v}
    check(not others, f"the eval path launched training kernels: {others}")
    peak = torch.cuda.max_memory_allocated()
    model.block_fn = fused_bottleneck
    check(seen <= checked, f"kernel launched at unchecked shapes {sorted(seen - checked)}")
    emit({"phase": "slice_summary", "kernel_launches": launches,
          "launch_shapes": sorted(seen), "peak_memory_bytes": peak,
          "peak_memory_gib": peak / 2**30})
    from maxsquareloss_torch.train.steps import make_eval_step

    step = make_eval_step(cfg, model)
    x, y = (torch.from_numpy(a).cuda() for a in batches[0][:2])
    step(x, y)
    phase_profile("eval_batch", lambda: step(x, y), top_n=12)
    return {"launches": launches}


def _profile_summary(prof) -> tuple[float, list]:
    """(device busy ms, events by device time) of a finished profile;
    device-side events only: a CPU op's device time repeats its kernels'."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return busy_ms, sorted(events, key=lambda e: e.self_device_time_total, reverse=True)


def _emit_profile(run: str, prof, wall: float, top_n: int, **extra) -> float:
    busy_ms, events = _profile_summary(prof)
    idle = 1.0 - busy_ms / (wall * 1e3)
    emit({"phase": "profile", "run": run, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "idle_share": idle, **extra,
          "top": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                   "calls": e.count} for e in events[:top_n]]})
    return idle


def phase_profile(run: str, fn, top_n: int) -> None:
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    after a warm call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _emit_profile(run, prof, wall, top_n)


def _worst(got, want) -> tuple[float, float]:
    """(max abs error, worst error over the rtol = atol = 1e-4 tolerance)."""
    err = (got - want).abs()
    return err.max().item(), (err / (ATOL + RTOL * want.abs())).max().item()


def _rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _loss_inputs(gen, n, h, w, c=NUM_CLASSES):
    """Logits with exact ties between classes 3 and 11 at the max on every
    7th pixel, and IW weights from a guidance label that ignores class 5,
    so class 5 takes the degenerate weight 1.0 where it is the argmax."""
    logits = torch.randn(n, h, w, c, generator=gen) * 3.0
    tied = logits.view(-1, c)[::7]
    top = tied.amax(dim=-1) + 1.0
    tied[:, 3] = top
    tied[:, 11] = top
    logits = logits.cuda()
    amax = logits.argmax(dim=-1)
    weights = iw_class_weights(class_histogram(torch.where(amax == 5, -1, amax), c))
    check(bool((weights == 1.0).any() and (amax == 5).any()), "no degenerate IW weight")
    check(bool((amax == 3).any()), "no tied pixel")
    return logits, weights


def _hold_loss(name, fn, plain, logits, weights) -> dict:
    """The loss kernel, forward and backward, against its plain version."""
    rest = () if weights is None else (weights,)
    g = torch.tensor(0.7, device="cuda")

    def value_and_grad(f):
        x = logits.clone().requires_grad_(True)
        loss = f(x, *rest)
        (dx,) = torch.autograd.grad(loss, x, g)
        return loss.detach(), dx

    loss_k, dx_k = value_and_grad(fn)
    loss_k2, dx_k2 = value_and_grad(fn)
    loss_p, dx_p = value_and_grad(plain)
    torch.cuda.synchronize()
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    dx_abs = (dx_k - dx_p).abs().max().item()
    dx_rel = dx_abs / dx_p.abs().max().item()
    check(torch.equal(loss_k, loss_k2) and torch.equal(dx_k, dx_k2),
          f"{name}: two calls differ (not bitwise deterministic)")
    check(math.isfinite(loss_k.item()), f"{name}: non-finite loss")
    check(rel <= LOSS_RTOL, f"{name}: loss {loss_k.item()} vs plain {loss_p.item()} (rel {rel:.3g})")
    check(dx_abs <= GRAD_ATOL and dx_rel <= GRAD_RTOL_MAX,
          f"{name}: dx off by {dx_abs:.3g} abs, {dx_rel:.3g} of the largest")
    return {"shape": list(logits.shape), "loss": loss_k.item(), "loss_plain": loss_p.item(),
            "rel_err": rel, "dx_max_abs_err": dx_abs, "dx_err_over_max": dx_rel,
            "bitwise_repeatable": True}


def phase_train_loss_kernels() -> list[dict]:
    """Both loss kernels at every shape of ``LOSS_SHAPES``; timed at the main
    path's, with the share of the bound each direction reaches. Returns four
    kernels-line entries."""
    gen = torch.Generator().manual_seed(1)
    variants = (
        ("fused_iw_max_square_loss", fused_iw_max_square_loss, fused_iw_max_square_loss_reference,
         "experiments/retired_pallas/fused_loss.py:137", "experiments/retired_pallas/fused_loss.py:156"),
        ("fused_max_square_loss", fused_max_square_loss, fused_max_square_loss_reference,
         "experiments/retired_pallas/fused_loss.py:50", "experiments/retired_pallas/fused_loss.py:63"),
    )
    entries = []
    for name, fn, plain, fwd_line, bwd_line in variants:
        rows = []
        for n, h, w in LOSS_SHAPES:
            logits, weights = _loss_inputs(gen, n, h, w)
            if name == "fused_max_square_loss":
                weights = None
            rows.append(_hold_loss(name, fn, plain, logits, weights))
            emit({"phase": "kernel_check", "kernel": name, **rows[-1]})
        # timed at the main path's shape (the last logits of the first shape)
        logits, weights = _loss_inputs(gen, *LOSS_SHAPES[0])
        if name == "fused_max_square_loss":
            weights = None
        rest = () if weights is None else (weights,)
        m = logits.numel()
        coef = -1.0 / m if weights is None else -2.0 / (logits.shape[0] * NUM_CLASSES)
        g = torch.tensor(0.7, device="cuda")
        x = logits.clone().requires_grad_(True)

        # both directions through their launch functions: the wrapper's
        # autograd bookkeeping on the host takes about as long as the forward
        # kernel on the card and would be timed in its place
        def k_fwd():
            return fused_loss._launch_forward(logits, weights, coef / 2)

        def k_bwd():
            return fused_loss._launch_backward(logits, weights, g, coef)

        def p_fwd():
            with torch.no_grad():
                return plain(logits, *rest)

        def p_both():
            return torch.autograd.grad(plain(x, *rest), x, g)

        def k_fwd_wrapper():
            return fn(logits, *rest)

        reps = 40
        pf1, kf1, kf2, pf2 = (time_ms_median(f, reps) for f in (p_fwd, k_fwd, k_fwd, p_fwd))
        # the forward as earlier revisions of this script timed it: the
        # wrapper, mean of 10 calls; read beside times they recorded
        fwd_wrapper_ms = (time_ms(k_fwd_wrapper, 10) + time_ms(k_fwd_wrapper, 10)) / 2
        pb1, kb1, kb2, pb2 = (time_ms_median(f, reps) for f in (p_both, k_bwd, k_bwd, p_both))
        plain_fwd = (pf1 + pf2) / 2
        w_bytes = 0 if weights is None else weights.numel() * 4
        for direction, line, ms, plain_ms, nbytes, flops in (
            ("", fwd_line, (kf1 + kf2) / 2, plain_fwd, 4 * m + w_bytes + 4, 10 * m),
            ("_backward", bwd_line, (kb1 + kb2) / 2, (pb1 + pb2) / 2 - plain_fwd,
             8 * m + w_bytes + 4, 14 * m),
        ):
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
            entries.append({
                "name": name + direction, "route": "cuda",
                "source": "maxsquareloss_torch/csrc/fused_loss.cu", "replaces": line,
                "launches": None,  # filled from the main path's run
                "max_abs_err": max(r["dx_max_abs_err"] if direction else
                                   abs(r["loss"] - r["loss_plain"]) for r in rows),
                "ms": ms, "ms_method": "launch function, median of 5 windows of 40 calls",
                "wrapper_ms_mean_of_10": None if direction else fwd_wrapper_ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "bound_share": max(t_ops, t_bytes) * 1e3 / ms,
                "library_ms": None,
                "library": "none: no single PyTorch call computes this loss",
                "shape": list(logits.shape), "checks": rows,
            })
            emit({"phase": "kernel", **{k: v for k, v in entries[-1].items() if k != "checks"}})
        del logits, weights, x
    torch.cuda.empty_cache()
    return entries


def _hold_emit(gen, name, n, h, w, cin, cmid, d) -> tuple[tuple, tuple, dict]:
    """One shape's inputs, the emit kernel's (out, h1, h2), and its errors
    against the plain version."""
    args = _block_inputs(gen, n, h, w, cin, cmid)
    got = fused_bottleneck_emit(*args, d)
    want = fused_bottleneck_emit_reference(*args, d)
    torch.cuda.synchronize()
    row = {"layer": name, "shape": [n, h, w, cin], "cmid": cmid, "dilation": d,
           **_tile_report(n, h, w, cin, cmid, d)}
    for label, a, b in zip(("out", "h1", "h2"), got, want):
        check(bool(torch.isfinite(a).all()), f"emit {name}: non-finite {label}")
        max_abs, worst = _worst(a, b)
        check(worst <= 1.0, f"emit {name} {label}: {max_abs:.3g} abs, {worst:.3g}x the tolerance")
        row[f"{label}_max_abs_err"], row[f"{label}_worst_over_tol"] = max_abs, worst
    return args, got, row


def phase_train_block() -> tuple[set, dict]:
    """The emit bottleneck at every training shape (out, h1, h2), timed;
    its autograd backward at one shape per layer. Returns the checked
    shapes and the kernels-line entry (times per train step)."""
    gen = torch.Generator().manual_seed(2)
    checked, rows = set(), []
    for name, n, h, w, cin, cmid, d, per_fwd in TRAIN_SHAPES:
        args, got, row = _hold_emit(gen, name, n, h, w, cin, cmid, d)
        checked.add((n, h, w, cin, cmid, d))
        if name == "layer3":  # no atomics: a second call gives the same bits
            check(all(torch.equal(a, b) for a, b in zip(got, fused_bottleneck_emit(*args, d))),
                  f"emit {name}: two calls differ (not bitwise deterministic)")
            row["bitwise_repeatable"] = True
        del got

        def kernel():
            return fused_bottleneck_emit(*args, d)

        def plain():
            return fused_bottleneck_emit_reference(*args, d)

        p1, k1, k2, p2 = (time_ms(f, 5) for f in (plain, kernel, kernel, plain))
        torch.backends.cudnn.allow_tf32 = True  # cuDNN at PyTorch's defaults
        lib_ms = time_ms(plain, 5)
        torch.backends.cudnn.allow_tf32 = False
        flops = 2 * n * h * w * (2 * cin * cmid + 9 * cmid * cmid)
        nbytes = 4 * (2 * n * h * w * (cin + cmid) + 2 * cin * cmid + 9 * cmid * cmid
                      + 4 * cmid + 2 * cin)
        row.update({"per_forward": per_fwd, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                    "library_ms": lib_ms,
                    "bound_ms": max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                    "tflops": flops / ((k1 + k2) / 2) / 1e9})
        emit({"phase": "kernel", "kernel": "fused_bottleneck_emit", **row})
        rows.append(row)
        del args

    # the backward at the source shape of each layer
    for name, n, h, w, cin, cmid, d, _ in TRAIN_SHAPES[:len(LAYERS)]:
        x, w1, w2, w3, *bn = _block_inputs(gen, n, h, w, cin, cmid)
        cot = torch.randn(n, h, w, cin, generator=gen).cuda().permute(0, 3, 1, 2)

        def grads(fn):
            xs = x.clone().requires_grad_(True)
            ws = [t.clone().requires_grad_(True) for t in (w1, w2, w3)]
            return torch.autograd.grad(fn(xs, *ws, *bn, d), [xs, *ws], cot)

        labels = ("dx", "dw1", "dw2", "dw3")
        want = grads(fused_bottleneck_reference)
        e2e = {k: _rel_l2(a, b) for k, a, b in zip(labels, grads(FusedBottleneckFn.apply), want)}
        with torch.no_grad():
            out_p, h1_p, h2_p = fused_bottleneck_emit_reference(x, w1, w2, w3, *bn, d)
            out_k, h1_k, h2_k = fused_bottleneck_emit(x, w1, w2, w3, *bn, d)
            adj = bottleneck_backward(cot, x, h1_p, h2_p, out_p, w1, w2, w3, bn[0], bn[2], bn[4], d)
            flips = {k: int(((a > 0) != (b > 0)).sum()) for k, a, b in
                     (("out", out_k, out_p), ("h1", h1_k, h1_p), ("h2", h2_k, h2_p))}
        adjoint = {k: _rel_l2(a, b) for k, a, b in zip(labels, adj, want)}
        for k in labels:
            check(adjoint[k] <= BACKWARD_RTOL_L2,
                  f"block backward {name} {k}: adjoint chain off by {adjoint[k]:.3g} (relative L2)")
            check(e2e[k] <= BACKWARD_E2E_RTOL_L2,
                  f"block backward {name} {k}: kernel path off by {e2e[k]:.3g} (relative L2)")
        emit({"phase": "kernel_check", "kernel": "fused_bottleneck_train_backward",
              "layer": name, "shape": [n, h, w, cin], "adjoint_rel_l2": adjoint,
              "kernel_path_rel_l2": e2e, "relu_mask_disagreements": flips})
        del x, w1, w2, w3, bn, cot, want, adj, out_p, h1_p, h2_p, out_k, h1_k, h2_k
    torch.cuda.empty_cache()

    def per_step(key):  # TRAIN_SHAPES holds one source and one target forward
        return sum(r[key] * r["per_forward"] for r in rows)

    return checked, {
        "name": "fused_bottleneck_emit", "route": "cuda",
        "source": "maxsquareloss_torch/csrc/fused_bottleneck.cu",
        "replaces": "experiments/retired_pallas/fused_block.py:153",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(r[f"{k}_max_abs_err"] for r in rows for k in ("out", "h1", "h2")),
        # times and bound: the 58 identity blocks of one train step
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"), "bound_by": "operations",
        "library_ms": per_step("library_ms"),
        "library": "the plain F.conv2d chain with cuDNN at PyTorch defaults (TF32 convs)",
        "shapes": rows,
    }


@contextlib.contextmanager
def plain_losses():
    """The train step's target loss through the loss kernels' plain versions."""
    saved = train_steps.fused_iw_max_square_loss, train_steps.fused_max_square_loss
    train_steps.fused_iw_max_square_loss = fused_iw_max_square_loss_reference
    train_steps.fused_max_square_loss = fused_max_square_loss_reference
    try:
        yield
    finally:
        train_steps.fused_iw_max_square_loss, train_steps.fused_max_square_loss = saved


def _train_pairs():
    def batches(hw, seed):
        ds = SyntheticSegDataset(length=2 * TRAIN_BATCH, hw=hw, seed=seed)
        return [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
                for x, y, _ in uint8_batches(ds, TRAIN_BATCH)]

    return [(xs, ys, xt) for (xs, ys), (xt, _) in zip(batches(SRC_HW, 3), batches(TGT_HW, 4))]


def phase_train(emit_checked: set) -> tuple[dict[str, int], float]:
    """The UDA step: parity of one kernel-path and one plain-path step, then
    the counted, timed main path. Returns the main path's launch counts and
    the median steps/s."""
    cfg = TRAIN_CFG
    pairs = _train_pairs()
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device="cuda")
    plain = DeepLabV2(model.cfg, plain_blocks=True).to(
        device="cuda", memory_format=torch.channels_last)
    plain.load_state_dict(model.state_dict())
    p0 = {name: p.detach().clone() for name, p in model.named_parameters()}
    step = make_uda_train_step(cfg)

    # kernel path vs plain path: one step each from the same weights
    state, m_k = step(make_train_state(model, cfg), *pairs[0])
    with plain_losses():
        _, m_p = step(make_train_state(plain, cfg), *pairs[0])
    check(set(m_k) == set(m_p), f"metrics {sorted(m_k)} vs {sorted(m_p)}")
    metric_err = {}
    for k in m_k:
        a, b = m_k[k].item(), m_p[k].item()
        metric_err[k] = abs(a - b) / max(abs(b), 1e-30)
        check(math.isfinite(a) and abs(a - b) <= STEP_RTOL * abs(b),
              f"train parity {k}: kernel {a} vs plain {b}")
    plain_params = dict(plain.named_parameters())
    param_err = {name: _rel_l2(p.detach() - p0[name], plain_params[name].detach() - p0[name])
                 for name, p in model.named_parameters()}
    worst = max(param_err, key=param_err.get)
    check(param_err[worst] <= STEP_PARAM_RTOL_L2,
          f"train parity: {worst} change off by {param_err[worst]:.3g} (relative L2)")
    emit({"phase": "train_parity", "metrics": {k: v.item() for k, v in m_k.items()},
          "metric_rel_err": metric_err, "param_change_rel_l2_max": param_err[worst],
          "param_change_rel_l2_worst": worst,
          "param_change_rel_l2_median": statistics.median(param_err.values())})
    del plain, plain_params, m_p
    torch.cuda.empty_cache()

    # record the shape of every emit launch on the main path
    seen = set()

    def recording(x, *args):
        n, cin, h, w = x.shape
        seen.add((n, h, w, cin, args[0].shape[-1], args[-1]))
        return FusedBottleneckFn.apply(x, *args)

    model.train_block_fn = recording
    p_start = {name: p.detach().clone() for name, p in model.named_parameters()}
    ms_step = make_uda_train_step(dataclasses.replace(cfg, target_mode="maxsquare"))
    per_step = {"IW_maxsquare": {"fused_bottleneck_emit": 58, "fused_iw_max_square_loss": 1,
                                 "fused_iw_max_square_loss_backward": 1},
                "maxsquare": {"fused_bottleneck_emit": 58, "fused_max_square_loss": 1,
                              "fused_max_square_loss_backward": 1}}

    # the main path, counted: every launch from here to the end is the path's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    secs, metrics = [], []
    runs = [("IW_maxsquare", step)] * (WARMUP_STEPS + REPS) + [("maxsquare", ms_step)]
    for i, (mode, fn) in enumerate(runs):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, *pairs[i % len(pairs)])
        torch.cuda.synchronize()
        if WARMUP_STEPS <= i < WARMUP_STEPS + REPS:
            secs.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in read_counts().items()}
        want = {k: per_step[mode].get(k, 0) for k in delta}
        check(delta == want, f"{mode} step {i}: launches {delta}, expected {want}")
        metrics.append({k: v.item() for k, v in m.items()})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    model.train_block_fn = FusedBottleneckFn.apply

    check(seen <= emit_checked, f"emit kernel launched at unchecked shapes {sorted(seen - emit_checked)}")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()), f"train step {i}: non-finite metrics {m}")
    unmoved = [name for name, p in model.named_parameters() if torch.equal(p.detach(), p_start[name])]
    check(not unmoved, f"parameters that did not move: {unmoved[:5]}")
    steps_per_s = sorted(1.0 / s for s in secs)
    emit({"phase": "train", "run": "uda_IW_maxsquare_r101", "iw_hist": cfg.iw_hist,
          "batch": TRAIN_BATCH,
          "source_hw": list(SRC_HW), "target_hw": list(TGT_HW), "warmup": WARMUP_STEPS,
          "reps": REPS, "seconds": secs,
          "steps_per_s_median": statistics.median(steps_per_s),
          "steps_per_s_min": steps_per_s[0], "steps_per_s_max": steps_per_s[-1],
          "images_per_s_median": 2 * TRAIN_BATCH * statistics.median(steps_per_s),
          "images_per_s_min": 2 * TRAIN_BATCH * steps_per_s[0],
          "images_per_s_max": 2 * TRAIN_BATCH * steps_per_s[-1],
          "peak_memory_bytes": peak, "peak_memory_gib": peak / 2**30,
          "launch_counts": counts, "launch_shapes": sorted(seen),
          "first_metrics": metrics[0], "last_iw_metrics": metrics[-2],
          "maxsquare_metrics": metrics[-1]})
    phase_profile("train_step", lambda: step(state, *pairs[0]), top_n=16)
    return counts, statistics.median(steps_per_s)


def _probe_inputs(gen, m, k, n, cells, dtype):
    def randn(*shape):
        return (torch.randn(*shape, generator=gen) * 0.05).to("cuda", dtype)

    # x lies at the head of a larger allocation whose tail holds 1e3: a
    # kernel that lets rows past M of the last cell into its sums fails its
    # tolerance by orders of magnitude
    storage = torch.full((cells * m + 64, k), 1e3, device="cuda", dtype=dtype)
    x = storage[:cells * m].view(cells, m, k)
    x.copy_(randn(cells, m, k))
    return torch.full((1, 1), 1e-3, device="cuda"), x, randn(k, n), randn(n, k)


def _probe_plan_report(dtype, k, n) -> dict:
    """The planner's fields of one launch, for the probe's lines."""
    plan = matmul_probe.plan_probe(dtype, k, n)
    return {"route": plan.route, "row_tile": plan.tm, "block_cols": plan.block_cols,
            "stage_rows": plan.stage_rows, "ring_depth": plan.depth,
            "bytes_in_flight": plan.bytes_in_flight, "cluster": 1,
            "flop_per_l2_weight_byte": plan.flop_per_l2_weight_byte,
            "smem_bytes": plan.smem_bytes}


def _probe_library(t, x, a, b, chain):
    """The same chain as batched ``torch.matmul`` in the inputs' type
    (cuBLAS; TF32 off), the yardstick the port never calls."""
    y = x + t.reshape(()).to(x.dtype)
    for i in range(chain):
        y = torch.relu(torch.matmul(y, a if i % 2 == 0 else b))
    return y.float().sum(dim=1, keepdim=True)


def phase_probe() -> dict:
    """The calibration probe against its plain version at every shape and
    type of ``PROBE_SHAPES`` x ``PROBE_TYPES`` (bitwise equal on a second
    call), timed at the defaults and the layer-4 widths. Returns the
    kernels-line entry (the main path's shape: the defaults in bf16)."""
    gen = torch.Generator().manual_seed(3)
    rows = []
    for name, m, k, n, cells, chain in PROBE_SHAPES:
        for dtype, odtype in PROBE_TYPES:
            t, x, a, b = _probe_inputs(gen, m, k, n, cells, dtype)
            got = matmul_chain(t, x, a, b, chain, odtype)
            again = matmul_chain(t, x, a, b, chain, odtype)
            want = matmul_chain_plain(t, x, a, b, chain, odtype)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            types = f"{str(dtype)[6:]}->{str(odtype)[6:]}"
            check(bool(torch.isfinite(got).all()), f"probe {name} {types}: non-finite output")
            check(scale > 0, f"probe {name} {types}: the plain output is all zero")
            check(torch.equal(got, again), f"probe {name} {types}: two calls differ")
            check(err <= PROBE_TOL[dtype] * scale,
                  f"probe {name} {types}: {err:.3g} abs at max |out| {scale:.3g}")
            row = {"shape": name, "m": m, "k": k, "n": n, "cells": cells, "chain": chain,
                   "types": types, **_probe_plan_report(dtype, k, n),
                   "max_abs_err": err, "max_abs_out": scale, "err_over_max": err / scale,
                   "tolerance": PROBE_TOL[dtype], "bitwise_repeatable": True}
            if name in PROBE_TIMED:
                reps = 5

                def kernel():
                    return matmul_chain(t, x, a, b, chain, odtype)

                def plain():
                    return matmul_chain_plain(t, x, a, b, chain, odtype)

                def library():
                    return _probe_library(t, x, a, b, chain)

                p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kernel, kernel, plain))
                lib_ms = time_ms(library, reps)
                es = torch.finfo(dtype).bits // 8
                flops = 2 * m * k * n * chain * cells
                nbytes = es * (cells * m * k + 2 * k * n) + 4 * (cells * n + 1)
                peak = PEAK_BF16_FLOPS if dtype == BF16 else PEAK_FP32_FLOPS
                t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
                ms = (k1 + k2) / 2
                row.update({"ms": ms, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
                            "bound_ms": max(t_ops, t_bytes) * 1e3,
                            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                            "tflops": flops / ms / 1e9, "library_tflops": flops / lib_ms / 1e9,
                            "peak_tflops": peak / 1e12})
            emit({"phase": "kernel" if "ms" in row else "kernel_check",
                  "kernel": "matmul_probe", **row})
            rows.append(row)
            del t, x, a, b, got, again, want
    torch.cuda.empty_cache()
    main_row = next(r for r in rows if r["shape"] == "defaults" and r["types"] == "bfloat16->bfloat16")
    return {
        "name": "matmul_probe", "route": "cuda",
        "source": "maxsquareloss_torch/csrc/matmul_probe.cu",
        "replaces": "experiments/bench_pallas_matmul.py:42",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{key: main_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "the same chain as batched torch.matmul in the inputs' type (cuBLAS, TF32 off)",
        "shapes": rows,
    }


def phase_probe_main() -> int:
    """The probe's entry point at its defaults, counted."""
    torch.cuda.synchronize()
    zero_counts()
    result = bench_matmul.main([])
    torch.cuda.synchronize()
    launches = matmul_chain.launches
    others = {k: v for k, v in read_counts().items() if k != "matmul_probe" and v}
    check(launches > 0, "bench_matmul launched no probe kernel")
    check(not others, f"bench_matmul launched other kernels: {others}")
    check(tuple(result["out"].shape) == (72, 1, 256) and bool(torch.isfinite(result["out"]).all()),
          "bench_matmul: output shape or values")
    emit({"phase": "probe_main", "entry": "maxsquareloss_torch.experiments.bench_matmul",
          "launches": launches, "ms": result["ms"], "tflops": result["tflops"],
          "peak_share": result["peak_share"]})
    return launches


def _scalars(run_dir: str) -> dict[str, dict[int, dict]]:
    """scalars.jsonl as {tag: {step: record}} (a later record of a step wins)."""
    out: dict[str, dict[int, dict]] = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec
    return out


def _trainer_loaders(cfg):
    """In-memory synthetic source (1280x640), target (1024x512) and val
    (1024x512) loaders: one epoch of TRAINER_ITERS batch pairs, val 2 x 2."""
    def loader(hw, n, seed, batch, train):
        return SegDataLoader(SyntheticSegDataset(length=n, hw=hw, seed=seed), batch_size=batch,
                             shuffle=train, num_workers=cfg.num_workers, seed=cfg.seed,
                             drop_last=train, pad_last=not train)

    n = TRAINER_ITERS * cfg.batch_size
    return (loader(SRC_HW, n, 3, cfg.batch_size, True), loader(TGT_HW, n, 4, cfg.batch_size, True),
            loader(TGT_HW, 2 * VAL_BATCH, 5, VAL_BATCH, False))


def phase_trainer(bare_steps_per_s: float) -> dict[str, int]:
    """The UDA trainer at full width over SegDataLoaders of in-memory data:
    TRAINER_ITERS iterations with a checkpoint every TRAINER_SAVE_ITER, a
    validation at the end; then a second trainer resumes the mid-epoch
    checkpoint with --continue_training and must reproduce the last
    iterations. Returns the first run's launch counts."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        cfg = dataclasses.replace(
            TRAIN_CFG, iter_stop=TRAINER_ITERS, save_iter=TRAINER_SAVE_ITER, num_workers=8,
            tqdm=False, show_num_images=0, checkpoint_dir=os.path.join(root, "run"))
        model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device="cuda")
        trainer = UDATrainer(cfg, *_trainer_loaders(cfg), model=model)
        resume_dir = os.path.join(root, "resume")
        os.makedirs(resume_dir)
        deltas = []
        run_step, save = trainer._run_step, trainer.save_checkpoint

        def counted_step(batch):
            before = read_counts()
            out = run_step(batch)
            deltas.append({k: v - before[k] for k, v in read_counts().items()})
            return out

        def save_and_keep(*args, **kw):
            path = save(*args, **kw)
            if trainer.state.iteration == TRAINER_SAVE_ITER:  # the resume's start
                shutil.copy(path, os.path.join(resume_dir, ckpt_lib.LATEST))
            return path

        trainer._run_step, trainer.save_checkpoint = counted_step, save_and_keep
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()

        per_iter = {"fused_bottleneck_emit": 58, "fused_iw_max_square_loss": 1,
                    "fused_iw_max_square_loss_backward": 1}
        want = {k: per_iter.get(k, 0) for k in COUNTERS}
        check(len(deltas) == TRAINER_ITERS and trainer.state.iteration == TRAINER_ITERS,
              f"trainer ran {len(deltas)} steps to iteration {trainer.state.iteration}")
        for i, d in enumerate(deltas):
            check(d == want, f"trainer iteration {i + 1}: launches {d}, expected {want}")
        val_launches = counts["fused_bottleneck"]
        check(val_launches == 29 * 2, f"validation launched the eval kernel {val_launches} times")
        scal = _scalars(cfg.checkpoint_dir)
        losses = scal["train/loss"]
        check(sorted(losses) == list(range(1, TRAINER_ITERS + 1)), f"loss steps {sorted(losses)}")
        check(all(math.isfinite(r["value"]) for r in losses.values()), "non-finite trainer loss")
        check("val/MIoU" in scal and math.isfinite(scal["val/MIoU"][TRAINER_ITERS]["value"]),
              "no validation mIoU")
        # steps/s: the intervals between the loss records of iterations 2..6
        ts = [losses[i]["ts"] for i in range(TRAINER_SAVE_ITER - 1, TRAINER_ITERS + 1)]
        trainer_steps_per_s = statistics.median(1.0 / (b - a) for a, b in zip(ts, ts[1:]))

        # the latest checkpoint loads and equals the live model
        latest = os.path.join(cfg.checkpoint_dir, ckpt_lib.LATEST)
        fresh = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(1), device="cuda")
        ckpt_lib.load_torch_pth(latest, fresh, cfg.num_classes)
        live = trainer.model.state_dict()
        unequal = [k for k, v in fresh.state_dict().items() if not torch.equal(v, live[k])]
        check(not unequal, f"checkpoint differs from the live model at {unequal[:5]}")
        del fresh
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint()
        save_s = time.perf_counter() - t0
        size = os.path.getsize(latest)
        del trainer, model
        torch.cuda.empty_cache()

        # resume from the iteration-3 checkpoint (--continue_training finds
        # it as the run dir's latest); profile iterations 4 and 5
        cfg2 = dataclasses.replace(cfg, continue_training=True, checkpoint_dir=resume_dir)
        model2 = init_deeplabv2(model_config(cfg2), torch.Generator().manual_seed(2), device="cuda")
        trainer2 = UDATrainer(cfg2, *_trainer_loaders(cfg2), model=model2)
        prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        window = {}
        run_step2 = trainer2._run_step

        def profiled_step(batch):
            it = trainer2.state.iteration
            if it in (TRAINER_SAVE_ITER, TRAINER_SAVE_ITER + 2):
                torch.cuda.synchronize()
                if it == TRAINER_SAVE_ITER:
                    prof.__enter__()
                    window["t0"] = time.perf_counter()
                else:
                    window["wall"] = time.perf_counter() - window["t0"]
                    prof.__exit__(None, None, None)
            return run_step2(batch)

        trainer2._run_step = profiled_step
        trainer2.main()
        torch.cuda.synchronize()
        check(trainer2.state.iteration == TRAINER_ITERS, f"resume ended at {trainer2.state.iteration}")
        resumed = _scalars(resume_dir)["train/loss"]
        check(sorted(resumed) == list(range(TRAINER_SAVE_ITER + 1, TRAINER_ITERS + 1)),
              f"resumed loss steps {sorted(resumed)}")
        rel = {i: abs(resumed[i]["value"] - losses[i]["value"]) / abs(losses[i]["value"])
               for i in resumed}
        check(max(rel.values()) <= TRAINER_RESUME_RTOL,
              f"resumed losses differ from the first run's: {rel}")
        idle = _emit_profile("trainer_2_iterations", prof, window["wall"], top_n=12,
                             iterations=[TRAINER_SAVE_ITER + 1, TRAINER_SAVE_ITER + 2])
        busy_per_iter_s = _profile_summary(prof)[0] / 2e3
        del trainer2, model2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gap = 1.0 - trainer_steps_per_s / bare_steps_per_s
    emit({"phase": "trainer", "run": "uda_trainer_IW_maxsquare_r101", "iw_hist": cfg.iw_hist,
          "batch": cfg.batch_size, "source_hw": list(SRC_HW), "target_hw": list(TGT_HW),
          "iterations": TRAINER_ITERS, "save_iter": TRAINER_SAVE_ITER, "seconds": seconds,
          "losses": {i: r["value"] for i, r in losses.items()},
          "trainer_steps_per_s_median": trainer_steps_per_s,
          "bare_step_steps_per_s_median": bare_steps_per_s, "gap_vs_bare_step": gap,
          # under the profiler its own host cost shows as idle (the loop
          # syncs once an iteration); the estimate divides the profiled
          # device time by the unprofiled iteration time
          "idle_share_2_iterations_profiled": idle,
          "idle_share_estimate": 1.0 - busy_per_iter_s * trainer_steps_per_s,
          "peak_memory_bytes": peak,
          "peak_memory_gib": peak / 2**30, "checkpoint_save_s": save_s,
          "checkpoint_bytes": size, "launch_counts": counts,
          "validation_eval_launches": val_launches,
          "resume_loss_rel_err": rel, "resume_bitwise_equal": all(v == 0.0 for v in rel.values())})
    return counts


LOSSES = {
    "fused_iw_max_square_loss": (fused_iw_max_square_loss, fused_iw_max_square_loss_reference),
    "fused_max_square_loss": (fused_max_square_loss, fused_max_square_loss_reference),
}


@contextlib.contextmanager
def recorded_shapes():
    """The shape of every kernel launch of the paths run inside: the
    bottleneck's (N, H, W, Cin, Cmid, d), eval and emit, from every fused
    block's forward, and the losses' logits (N, H, W, C) from the train
    step's calls."""
    seen = {"fused_bottleneck": set(), "fused_bottleneck_emit": set(),
            **{name: set() for name in LOSSES}}
    forward = Bottleneck.forward

    def recording_forward(self, x, kernel, train_kernel):
        if self.fusable and kernel is fused_bottleneck:
            n, cin, h, w = x.shape
            key = "fused_bottleneck_emit" if torch.is_grad_enabled() else "fused_bottleneck"
            seen[key].add((n, h, w, cin, self.conv1.out_channels, self.dilation))
        return forward(self, x, kernel, train_kernel)

    def recording_loss(name, fn):
        def loss(logits, *rest):
            seen[name].add(tuple(logits.shape))
            return fn(logits, *rest)
        return loss

    saved = {name: getattr(train_steps, name) for name in LOSSES}
    Bottleneck.forward = recording_forward
    for name, fn in saved.items():
        setattr(train_steps, name, recording_loss(name, fn))
    try:
        yield seen
    finally:
        Bottleneck.forward = forward
        for name, fn in saved.items():
            setattr(train_steps, name, fn)


def hold_path_shapes(path: str, seen: dict, checked: dict) -> None:
    """Hold each kernel against its plain version at every shape ``path``
    launched it at that no phase has checked yet; adds them to ``checked``."""
    gen = torch.Generator().manual_seed(5)
    for kernel, shapes in seen.items():
        for shape in sorted(shapes - checked[kernel]):
            if kernel == "fused_bottleneck":
                args, row = _hold_block(gen, path, *shape)
            elif kernel == "fused_bottleneck_emit":
                args, _, row = _hold_emit(gen, path, *shape)
            else:
                args = _loss_inputs(gen, *shape)
                fn, plain = LOSSES[kernel]
                weights = None if kernel == "fused_max_square_loss" else args[1]
                row = _hold_loss(kernel, fn, plain, args[0], weights)
            emit({"phase": "kernel_check", "kernel": kernel, "path": path, **row})
            checked[kernel].add(shape)
            del args
    torch.cuda.empty_cache()


def phase_cli(root: str) -> UDATrainer:
    """One short ``solve_gta5`` run through the real CLI on a small on-disk
    domain-shift pair under ``root`` (PIL writes and reads the PNGs: the run
    fails without it); full-width R101 at 128x256 crops. Returns the trainer,
    whose model ``phase_serving_cli`` holds the serving CLIs against."""
    check(importlib.util.find_spec("PIL") is not None, "PIL is not installed: the CLI phases need it")
    from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
    from maxsquareloss_torch.tools import solve_gta5

    data = os.path.join(root, "data")
    write_domain_shift_pair(data, n_source=8, n_target_train=8, n_target_val=4, hw=(128, 256))
    zero_counts()
    t0 = time.perf_counter()
    trainer = solve_gta5.main([
        "--data_root_path", data, "--checkpoint_dir", os.path.join(root, "run"),
        *CLI_SIZE, "--target_base_size", "256,128", "--target_crop_size", "256,128",
        *CLI_COMMON, "--iter_stop", "2", "--iw_hist", "argmax"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check(trainer.state.iteration == 2, f"solve_gta5 ended at {trainer.state.iteration}")
    check(os.path.exists(os.path.join(root, "run", ckpt_lib.LATEST)), "solve_gta5: no checkpoint")
    check(counts["fused_bottleneck_emit"] == 2 * 58 and counts["fused_bottleneck"] > 0,
          f"solve_gta5 launches {counts}")
    miou = _scalars(os.path.join(root, "run"))["val/MIoU"][2]["value"]
    emit({"phase": "cli", "entry": "maxsquareloss_torch.tools.solve_gta5", "seconds": seconds,
          "iterations": 2, "val_MIoU": miou, "launch_counts": counts})
    return trainer


def _counted_cli(name: str, fn, images: int | None, expect: dict[str, int]) -> tuple:
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (its result, the counts, the JSON line's fields). ``expect`` maps
    kernels to the launches they must show; every other count must be 0."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    want = {k: expect.get(k, 0) for k in counts}
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    line = {"entry": name, "seconds": seconds, "launch_counts": counts}
    if images:
        line.update(images=images, images_per_s_with_load=images / seconds)
    return out, counts, line


def phase_serving_cli(root: str, trainer: UDATrainer) -> None:
    """The port's ``evaluate`` and ``predict`` CLIs on ``phase_cli``'s
    checkpoint: the file round trip and the CLI must give the in-process
    model's mIoU (1e-4) and trainIds (99.9 % of pixels). Each line's rate
    includes loading the model."""
    from PIL import Image

    from maxsquareloss_torch.data.transforms import img_transform
    from maxsquareloss_torch.tools import evaluate as evaluate_cli
    from maxsquareloss_torch.tools import predict as predict_cli

    data = os.path.join(root, "data")
    n_val = len(trainer.val_loader.dataset)
    batches = -(-n_val // trainer.val_loader.batch_size)
    want = evaluate(trainer.model, trainer.cfg, trainer.val_loader)["MIoU"]
    served = ["--dataset", "cityscapes", "--data_root_path", data,
              "--pretrained_ckpt_file", os.path.join(root, "run", ckpt_lib.LATEST),
              *CLI_SIZE, *CLI_COMMON]
    scales = ["--scales", ",".join(str(s) for s in PREDICT_SCALES), "--flip", "true"]
    for case, flags, forwards in (("single_scale", [], batches),
                                  ("multiscale_flip", scales, batches * len(PREDICT_SCALES)),
                                  ("full_res_labels", ["--full_res_labels", "true"], batches)):
        out, _, line = _counted_cli(
            "maxsquareloss_torch.tools.evaluate",
            lambda: evaluate_cli.main([*served, "--checkpoint_dir", os.path.join(root, f"ev_{case}"),
                                       *flags]),
            n_val, {"fused_bottleneck": 29 * forwards})
        check(all(math.isfinite(v) for v in out.values()), f"evaluate {case}: {out}")
        if case == "single_scale":
            check(abs(out["MIoU"] - want) <= 1e-4,
                  f"evaluate CLI mIoU {out['MIoU']} vs the in-process model's {want}")
        emit({"phase": "serving_cli", "case": case, **line, **out, "in_process_MIoU": want})

    pred_dir = os.path.join(root, "pred")
    n, _, line = _counted_cli(
        "maxsquareloss_torch.tools.predict",
        lambda: predict_cli.main([*served, "--checkpoint_dir", os.path.join(root, "ev_pred"),
                                  "--output_dir", pred_dir, *scales]),
        n_val, {"fused_bottleneck": 29 * n_val * len(PREDICT_SCALES)})
    with open(os.path.join(data, "Cityscapes", "val.txt")) as f:
        rels = f.read().split()
    stems = [os.path.splitext(os.path.basename(r))[0] for r in rels]
    written = sorted(f for f in os.listdir(pred_dir) if f.endswith(".png"))
    check(n == len(rels) and written == sorted(f"{s}_{k}.png" for s in stems
                                               for k in ("trainids", "color")),
          f"predict wrote {written}")
    for stem in stems:
        ids = np.asarray(Image.open(os.path.join(pred_dir, f"{stem}_trainids.png")))
        check(bool(((ids < 19) | (ids == 255)).all()), f"predict {stem}: trainIds out of range")
    first = np.asarray(Image.open(os.path.join(pred_dir, f"{stems[0]}_trainids.png")))
    pil = Image.open(os.path.join(data, "Cityscapes", rels[0])).convert("RGB")
    x = torch.from_numpy(img_transform(pil, trainer.cfg.numpy_transform)[None]).cuda()
    ref = make_predict_fn(trainer.cfg, trainer.model, PREDICT_SCALES, flip=True,
                          out_hw=first.shape)(x)[0].cpu().numpy()
    agree = float((first == ref).mean())
    check(agree >= 0.999, f"predict CLI trainIds agree with the in-process model on {agree:.5f}")
    emit({"phase": "serving_cli", "case": "predict_multiscale_flip", **line,
          "first_image_agreement": agree})


def phase_crosscity() -> None:
    """``solve_crosscity`` for 2 iterations, Cityscapes → a synthetic NTHU
    Rio at 128x256, full-width R101 on the 13-class protocol."""
    from maxsquareloss_torch.data.synthetic import write_crosscity, write_domain_shift_pair
    from maxsquareloss_torch.tools import solve_crosscity

    root = tempfile.mkdtemp(prefix="chip_smoke_crosscity_")
    try:
        data = os.path.join(root, "data")
        write_domain_shift_pair(data, n_source=1, n_target_train=8, n_target_val=1, hw=(128, 256))
        write_crosscity(data, "Rio", n_train=8, n_val=4, hw=(128, 256))
        run = os.path.join(root, "run")
        trainer, counts, line = _counted_cli(
            "maxsquareloss_torch.tools.solve_crosscity",
            lambda: solve_crosscity.main([
                "--city_name", "Rio", "--data_root_path", data, "--checkpoint_dir", run, *CLI_SIZE,
                "--target_base_size", "256,128", "--target_crop_size", "256,128", *CLI_COMMON,
                "--iter_stop", "2", "--iw_hist", "argmax"]),
            2 * 2 * 2, {"fused_bottleneck_emit": 2 * 58, "fused_iw_max_square_loss": 2,
                        "fused_iw_max_square_loss_backward": 2, "fused_bottleneck": 29 * 2})
        check(trainer.state.iteration == 2, f"solve_crosscity ended at {trainer.state.iteration}")
        check(trainer.cfg.num_classes == 13, f"solve_crosscity: {trainer.cfg.num_classes} classes")
        check(os.path.exists(os.path.join(run, ckpt_lib.LATEST)), "solve_crosscity: no checkpoint")
        miou = _scalars(run)["val/MIoU"][2]["value"]
        check(math.isfinite(miou), f"solve_crosscity: val/MIoU {miou}")
        emit({"phase": "crosscity", **line, "iterations": 2, "num_classes": 13, "val_MIoU": miou})
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_bench() -> None:
    """The port's bench, in this process, in each mode: its JSON on a line of
    its own, then the run's launch counts, each exact."""
    from maxsquareloss_torch import bench

    root = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    warmup, steps = 2, 5
    calls = warmup + 2 * steps  # warm-up, then two timed passes
    short = ["--steps", str(steps), "--warmup", str(warmup)]
    # e2e: 16 images a domain at batch 8 are 2 steps an epoch; 4 legs of a
    # priming and a timed epoch, then 2 + 6 device-only steps
    e2e_steps = 4 * 2 * 2 + 8
    uda = {"fused_bottleneck_emit": 58, "fused_iw_max_square_loss": 1,
           "fused_iw_max_square_loss_backward": 1}
    runs = (
        ("uda", ["--mode", "uda", *short],
         {**{k: v * calls for k, v in uda.items()}, "fused_bottleneck": 29 * calls}),
        ("source", ["--mode", "source", *short], {"fused_bottleneck_emit": 29 * calls}),
        ("infer", ["--mode", "infer", *short], {"fused_bottleneck": 29 * calls}),
        ("infer_fullres_labels", ["--mode", "infer", "--label_hw", "1024,2048", *short],
         {"fused_bottleneck": 29 * calls}),
        ("e2e", ["--mode", "e2e", "--n_per_domain", "16", "--epochs", "1",
                 "--data_root", os.path.join(root, "data")],
         {k: v * e2e_steps for k, v in uda.items()}),
    )
    try:
        for name, argv, expect in runs:
            result, _, line = _counted_cli("maxsquareloss_torch.bench", lambda: bench.main(argv),
                                           None, expect)
            check(result["value"] > 0, f"bench {name}: value {result['value']}")
            check(math.isfinite(result["extra"]["final_loss"]),
                  f"bench {name}: final_loss {result['extra']['final_loss']}")
            emit({"phase": "bench", "run": name, "argv": argv, "seconds": line["seconds"],
                  "metric": result["metric"], "value": result["value"],
                  "launch_counts": line["launch_counts"]})
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_efficacy() -> None:
    """The adaptation-efficacy gate at ``tests/test_adaptation.py``'s
    protocol through the port's CLIs on the card: seed 0, 300 source
    iterations, then the lambda_target 0 control and IW_maxsquare at lambda
    64 for 200 iterations each (--blocks 1,1,2,1, 128x64, batch 8). UDA must
    beat both the control and source-only by more than 0.03."""
    from maxsquareloss_torch.experiments import adaptation_efficacy

    args = adaptation_efficacy.parse_args(["--seeds", "0", "--modes", "IW_maxsquare@64"])
    uda_steps = 2 * args.iters_uda  # the control's and the IW arm's
    # --blocks 1,1,2,1 has one identity block; 4 evaluations of 16 images in
    # batches of 8
    expect = {"fused_bottleneck_emit": args.iters_src + 2 * uda_steps, "fused_bottleneck": 4 * 2,
              **{k: args.iters_uda for k in ("fused_iw_max_square_loss",
                                              "fused_iw_max_square_loss_backward",
                                              "fused_max_square_loss",
                                              "fused_max_square_loss_backward")}}
    work = tempfile.mkdtemp(prefix="chip_smoke_efficacy_")
    try:
        res, counts, line = _counted_cli("maxsquareloss_torch.experiments.adaptation_efficacy",
                                         lambda: adaptation_efficacy.run_seed(work, 0, args),
                                         None, expect)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    src, ctrl, uda = res["source_only"], res["control_l0"], res["IW_maxsquare@64"]
    emit({"phase": "efficacy", "seed": 0, "iters_src": args.iters_src, "iters_uda": args.iters_uda,
          "in_domain": res["in_domain"], "source_only": src, "control_l0": ctrl,
          "IW_maxsquare_lambda64": uda, "uda_minus_control": uda - ctrl,
          "uda_minus_source_only": uda - src, "wall_seconds": line["seconds"],
          "launch_counts": counts})
    check(uda > ctrl + 0.03, f"UDA {uda:.4f} does not beat the lambda_target=0 control {ctrl:.4f} by 0.03")
    check(uda > src + 0.03, f"UDA {uda:.4f} does not beat source-only {src:.4f} by 0.03")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    checked, kernel = phase_kernels()
    kernel["launches"] = phase_slice(checked)["launches"]
    train_kernels = phase_train_loss_kernels()
    emit_checked, emit_kernel = phase_train_block()
    train_kernels.insert(0, emit_kernel)
    counts, bare_steps_per_s = phase_train(emit_checked)
    for k in train_kernels:
        k["launches"] = counts[k["name"]]
    probe = phase_probe()
    probe["launches"] = phase_probe_main()
    phase_trainer(bare_steps_per_s)
    # the later paths: every launch shape no phase above checked is held
    # against the plain version after the path's run
    loss_checked = {(*shape, NUM_CLASSES) for shape in LOSS_SHAPES}
    checked_all = {"fused_bottleneck": checked, "fused_bottleneck_emit": emit_checked,
                   **{name: set(loss_checked) for name in LOSSES}}
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with recorded_shapes() as seen:
            trainer = phase_cli(root)
            phase_serving_cli(root, trainer)
            del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    hold_path_shapes("cli", seen, checked_all)
    for path, phase in (("crosscity", phase_crosscity), ("bench", phase_bench),
                        ("efficacy", phase_efficacy)):
        with recorded_shapes() as seen:
            phase()
        hold_path_shapes(path, seen, checked_all)
    for k in (kernel, *train_kernels, probe):
        check(k["launches"] > 0, f"the main path launched no {k['name']}")
    emit({"phase": "summary", "wall_seconds": time.perf_counter() - t_start})
    emit({"kernels": [{key: v for key, v in k.items() if key not in ("shapes", "checks")}
                      for k in (kernel, *train_kernels, probe)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
