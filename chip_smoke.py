#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:
  1. environment: the card (as nvidia-smi reports name and power limit),
     torch and CUDA versions; TF32 is switched off for cuDNN and matmul so
     every plain fp32 reference runs in full fp32; the host's CPU count,
     the Pillow version, whether g++ is there and preprocesses png.h and
     zlib.h, whether Python.h is there, and whether the grain package
     imports (in a child process);
  2. build: compiles every kernel source of the port from
     ``maxsquareloss_torch/csrc``, one ``nvcc`` per library, all at once
     (the fused bottleneck twice: fp32, and bf16 with ``-DMSL_BF16``), with
     each bottleneck kernel instance's registers a thread and stack bytes
     (spills) as ``cuobjdump --dump-resource-usage`` reads them; a bf16
     instance with stack bytes fails the run;
  2b. hostops: the host extension (``maxsquareloss_torch/csrc/hostops.cpp``,
     PNG decode over zlib, no libpng) built by g++ (its seconds); every PNG
     kind x ``expand_rgb`` decoded bitwise as the card's PIL reads it, 200
     blur draws byte-exact against the card's Pillow, the fused train/val
     routes and the raw route bitwise against the general path with the
     extension off on a small synthetic root, and ms a sample, one thread,
     at 1914x1052 → base 1280x720 from native-size PNGs, prepared PNGs and
     prepared raw sidecars, each with the extension and with PIL
     (``experiments/host_data.py``); the run fails where the extension
     cannot be built, so the loader never reads through PIL unnoticed;
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
 11. concat: the UDA step with --concat_batches (source and target as one
     forward over 8 images on the 1280x640 canvas, the target images valid
     over their 1024x512 extents). Both bottleneck kernels in the masked
     mode at the step's 4 identity-block shapes against the masked plain
     version (rtol = atol = 1e-4), h1 exactly 0 in the pad region, the same
     bits on a second call, each timed beside the unmasked kernel; one
     concat step against one two-forward step and one plain-path concat
     step from the same weights (the train phase's limits); 2 warm-up and
     REPS timed steps of each (steps/s, peak memory; 29 masked emit launches
     a concat step against 58 unmasked, each loss kernel once a direction);
     a profile of one concat step; a UDATrainer with --concat_batches true
     --profile for 6 iterations, whose trace under checkpoint_dir/profile
     must name the bottleneck kernel;
 11b. bf16 kernels: both bf16 instances of the fused bottleneck (eval and
     emit) against their bf16 plain versions at every shape of the bf16
     paths (predict's TTA and the batch-2 eval forward, the UDA step's, the
     concat canvas masked): out, h1, h2 within 2 bf16 ulps of the plain
     version's largest magnitude, the share of bitwise-equal elements, the
     eval out equal to the emit out, a second call the same bits; eval timed
     at the eval shapes, emit at the step's, beside the bf16 plain version
     (the cuDNN bf16 chain), the bound at 989 TFLOP/s bf16 or 3.35 TB/s and
     the FMA route's ceiling at 67 TFLOP/s. The bf16 instance runs every
     conv on wgmma (conv2 two output rows a pass): each row and the kernels
     line name each conv's route, and each row the plan (m64 tiles and the
     share of their rows in use, stages) and its launches that put conv2 on
     wgmma (``conv2_tc_launches``: every one; the exact launch checks of
     every later phase hold the ``*_bf16_conv2_fma`` counts at 0); the
     summary carries the bf16 instances' registers and stack bytes, and a
     spill fails the run (as in the build phase);
 11c. bf16: the train phase's step with --compute_dtype bfloat16 from the
     same seeded weights: one kernel-path step against one plain-path step
     (every metric within 1e-2 relative beyond what bf16 moves it from the
     fp32 step, each parameter's change within 3e-2 relative L2), then
     steps 2-10 counted (58 bf16 emit launches a step at checked shapes; 2
     warm-up, 5 timed: steps/s, images/s, peak memory), the 10 steps'
     trajectory against 10 fp32 steps with the JAX package's bounds (loss
     2 % a step and 1 % on average, parameters 5e-3 relative L2), a profile
     of one step; ``evaluate`` and predict in bf16 (argmax agreement with
     the fp32 path, 5 timed drives, 29 bf16 eval launches a forward); 5
     concat steps in bf16 (29 masked bf16 emit launches a step);
 11d. remat: the fp32 and the bf16 step with --remat stages against the
     step without from the same weights (each dtype's limits above), each
     step's peak memory, 2 + 5 remat steps (steps/s, 116 emit launches a
     step);
 11e. int8: each kind of int8 site at R101's eval shapes (the stem's 7x7
     stride 2, 1x1 at stride 1 and 2, the 3x3 at dilation 1, 2, 4): the
     card's int8 product (torch._int_mm) bitwise equal to the CPU's int32
     product of the same tensors, timed beside the whole int8 site and the
     bf16 cuDNN conv; then in bf16 from seeded weights the int8 model
     (quantize_from_loader over the 3 eval batches, each identity block
     calibrated through the bf16 emit kernel: 29 launches a batch) in ``evaluate``
     (1024x512, 3 batches of 2) and predict (0.75,1.0 + flip), REPS times
     each, beside the bf16 kernel path and the bf16 plain path (the cuDNN
     chain) in this call: images/s, 29 eval launches a forward on the kernel
     path and none on the others, a profile of one batch of each, and the
     int8 trainIds against the plain path's (informational);
 11f. export: ``tools.export_inference`` on the card at R101, batch 2,
     512x1024, in bf16 (bf16 parameters embedded) and in int8 (calibrated
     on 4 images through the bf16 emit kernel), one copy of each kernel in
     either artifact; each
     artifact's ``--load --selftest`` in a fresh process (equal to the live
     graph rebuilt from the sidecar, exact; 29 eval kernel launches a
     forward in bf16, none in int8), then each artifact's forward beside
     its live graph's in this process (images/s, launches counted);
     phases 11e-11f record every kernel launch's shape, as the later phases;
 12. cli: ``tools.solve_gta5`` for 2 iterations on a small on-disk
     domain-shift pair at 128x256 (PIL is required: the run fails without it);
 13. serving_cli: ``tools.evaluate`` on that run's ``checkpoint_latest.pth``
     (single scale: mIoU within 1e-4 of ``evaluate`` on the trainer's model
     in this process; scales 0.75,1.0 + flip; --full_res_labels) and
     ``tools.predict`` with scales 0.75,1.0 + flip (a PNG pair per image,
     trainIds in 0..18, the first image's equal to ``make_predict_fn`` on
     99.9 % of the pixels), each with its exact eval-kernel launch count;
 14. crosscity: ``tools.solve_crosscity`` for 2 iterations, Cityscapes → a
     synthetic NTHU Rio at 128x256, 13 classes;
 15. bench: ``maxsquareloss_torch.bench`` in this process at its defaults
     (bf16) in modes uda (the JAX bench's default line: the bf16 step, bf16
     inference, the fp32 parity leg with stage remat at batch 8), uda with
     --concat (equal crops: one unmasked forward over 16 images) and source
     (5 timed steps after 2), infer at 1024x512 with 1024x512 and 1024x2048
     labels and with --quantize int8 (no fused launch after the
     calibration's 29 emit launches; the uda line carries value_infer_int8
     too), and e2e at the protocol's disk sizes over 8 images a domain
     (one step an epoch) for one epoch a leg, the host extension serving
     every decode of the cold and prepared legs (``hostops: true``, from
     its call counts), no decode on the raw leg and the blur on every leg;
     then uda and infer (both label sizes) again with ``--dtype float32``
     (uda with --concat, source, int8 and e2e only in bf16); each prints
     its JSON line;
 16. efficacy: the adaptation-efficacy gate at ``tests/test_adaptation.py``'s
     protocol (seed 0, --blocks 1,1,2,1, 128x64, batch 8, 300 source and
     200 UDA iterations, lambda 64): IW_maxsquare must beat the
     lambda_target 0 control and source-only by more than 0.03 mIoU.
     Phases 12-16 record every kernel launch's shape; each shape no earlier
     phase checked is then held against the plain version (tolerances of
     phases 3 and 6);
 16b. sp: spatial partitioning (``--sp``) of the serving and evaluation
     forward, two gloo ranks sharing the card as one space group, started
     once by ``torchrun`` (this script with ``--ddp-worker sp``): in fp32
     (TF32 off) and in bf16 from the same seeded R101 weights, each rank's
     rows of the eval forward at 1024x512, batch 2, against the rows of the
     one-process kernel-path forward (fp32 within 1e-4 of the largest
     |logit|, bf16 within 1e-2 of it or within the one-process bf16
     forward's own distance from fp32 where that is larger; argmax >= 99.9 %
     and >= 99 %), ``evaluate``'s step over 2048x1024 labels (the matrices
     summed over the ranks: every valid pixel, fp32 mIoU within 1e-4 of the
     one process's) and predict at 2048x1024, batch 1, scales 0.75,1.0 +
     flip (each rank's rows, and the rows rank 0 gathers); every rank's
     eval-kernel launches equal to the identity blocks whose map it owns
     rows of (29 a forward here), and every shard shape it launched at held
     against the plain version afterwards (phase 3's tolerance; bf16 the
     bf16 phase's). Each rank reports the halo bytes it sent and received,
     its exchanges and their ms a forward, and its forward ms beside the
     one-process forward's (informational: two ranks share one card and
     exchange through the host). Then, in the same ranks, training under
     ``--sp``: the UDA step (IW_maxsquare, ``--iw_hist argmax``) on the
     train phase's global batch (4 + 4 images at 1280x640 and 1024x512),
     fp32 and bf16, each rank its rows, against the one-process kernel-path
     step from the same weights that this process runs first (fp32 the
     n-rank limits, metrics rel 1e-4 and parameter changes 1e-3 relative
     L2; bf16 the bf16 step's, thresholded metrics beyond the fp32 step's
     distance), every rank's parameters equal, exact launches per rank (58
     emit, one IW forward and backward a step), a warm-up and 2 timed
     steps beside the one-process step's, halo bytes forward and backward,
     peak memory; the fp32 step with ``--concat_batches true`` (the masked
     canvas on row shards: 29 masked emit launches a step a rank) and with
     ``--remat stages`` (116 emit launches a step a rank, the exchanges and
     halo bytes exactly the step's without remat), each against its
     one-process step at the fp32 limits; every emit (masked too) and loss
     shard shape held afterwards; ``UDATrainer --sp`` for 2 iterations and
     a validation against the one-process trainer (losses rel 1e-4, mIoU
     within 1e-4); and, where the ranks are one space group, the sharded
     serving export: ``tools.export_inference --sp`` of a seeded R101
     ``.pth`` in bf16 at batch 1, 1024x2048 (one graph a rank), ``--load
     --selftest`` on every rank (exact against the live ``--sp`` graph, 29
     eval launches a forward a rank), the whole map every rank returns >=
     99.9 % equal to the one-process bf16 artifact's that this process
     exports first, the halo bytes of a forward, and the artifact's
     images/s beside its live graph's;
 17. ddp: data parallelism, each rank a process started by ``torchrun``
     (this script with ``--ddp-worker``, or a CLI module). The emit and IW
     loss kernels are first held against their plain versions at the
     ranks' shapes. (a) two gloo ranks share the card (NCCL refuses two
     ranks on one device), each with 2 of the 4 + 4 images: an
     IW_maxsquare step, then a hard step whose ranks differ in their valid
     pixel counts, against the one-process steps on the same global
     batches from the same weights (the train phase's limits), with each
     rank's launch counts beside the one-process counts and no DDP
     warning about gradient strides; (b) ``torchrun --nproc_per_node``
     (the card count) with NCCL: ``solve_gta5`` for 2 iterations with a
     validation and a checkpoint (with one card this is world 1: no DDP
     wrapper and no collective); (c) with two or more cards, (a) over them
     with NCCL and the step rate at 4 + 4 images a card beside one card's;
     with one card a line says it did not run. ``python3 chip_smoke.py
     --ddp-cards`` on a machine with several cards runs the build, the
     kernels at the ranks' shapes, the one-process steps and one card's
     rate, then (c) and (b) over every card, (b) with what the default run
     leaves out (the ``--continue_training`` resume to iteration 4,
     ``tools.evaluate`` against the one-process mIoU within 1e-4, and the
     UDATrainer at full width within 5 % of the bare step), then the sp
     phase over the cards with NCCL (sp = the card count, and dp2 x sp2 on
     four; its training legs too), then ``torchrun solve_gta5 --sp 2``
     over every card (dp x sp) against the one-process run, and nothing
     else.
All full-width phases run R101 (blocks 3,4,23,3), in fp32 with TF32 off
unless they say bf16.
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
import re
import shutil
import statistics
import subprocess
import sys
import sysconfig
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
    valid_mask,
)
from maxsquareloss_torch.kernels.fused_loss import (
    fused_iw_max_square_loss,
    fused_iw_max_square_loss_reference,
    fused_max_square_loss,
    fused_max_square_loss_reference,
)
from maxsquareloss_torch.kernels.matmul_probe import matmul_chain, matmul_chain_plain
from maxsquareloss_torch.models import layers as model_layers
from maxsquareloss_torch.models.deeplabv2 import (
    Bottleneck,
    DeepLabV2,
    init_deeplabv2,
    make_canvas_masks,
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
from maxsquareloss_torch.utils.device import resolve_device

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
# the concat UDA step (--concat_batches): the same batches as one forward over
# 8 images on a canvas of the larger crop, the target images valid over
# their own extents (layer1 161x321 valid over 129x257, layers 2-4 81x161
# over 65x129)
CONCAT_CFG = dataclasses.replace(TRAIN_CFG, concat_batches=True)
CANVAS_HW = (max(SRC_HW[0], TGT_HW[0]), max(SRC_HW[1], TGT_HW[1]))
CANVAS_GROUPS = [(TRAIN_BATCH, SRC_HW), (TRAIN_BATCH, TGT_HW)]
CONCAT_SHAPES = block_shapes(2 * TRAIN_BATCH, CANVAS_HW)
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
# bf16 (--compute_dtype bfloat16, PERF.md section 2): each bf16 instance's
# out, h1, h2 within BF16_ULPS bf16 ulps of its bf16 plain version's largest
# magnitude (the same roundings, fp32 sums in another order); the bf16 step,
# kernel path against plain path from the same weights, every metric within
# BF16_STEP_RTOL relative, the BF16_THRESHOLDED ones (counted over the
# thresholded pseudo-label set, which a 1-ulp logit decides a pixel of, and
# the IW weights' maximum) within it beyond what bf16 moves them (their
# distance from the fp32 kernel-path step from those weights), each
# parameter's change within BF16_PARAM_RTOL_L2 relative L2; TRAJ_STEPS bf16
# steps against fp32 steps with the JAX package's bf16 trajectory bounds
# (tests/test_steps.py: per-step loss 2 %, mean 1 %, parameters 5e-3
# relative L2)
BF16_ULPS = 2
BF16_STEP_RTOL, BF16_PARAM_RTOL_L2 = 1e-2, 3e-2
BF16_THRESHOLDED = {"guidance_valid_frac", "loss_target_aux", "iw_pixel_w_max"}
BF16_LIMITS = (BF16_STEP_RTOL, BF16_PARAM_RTOL_L2)
TRAJ_STEPS = 10
TRAJ_LOSS_MAX, TRAJ_LOSS_MEAN, TRAJ_PARAM_RTOL_L2 = 0.02, 0.01, 5e-3
BF16_CFG = dataclasses.replace(TRAIN_CFG, compute_dtype="bfloat16")
# the trainer: 6 iterations, a checkpoint at 3, a resume that runs 4-6 again
# and matches the first run's losses to relative 1e-4 (cuDNN's backward is
# left nondeterministic, as in training); validation over 2 batches of 2
TRAINER_ITERS, TRAINER_SAVE_ITER, TRAINER_RESUME_RTOL = 6, 3, 1e-4
VAL_BATCH = 2
# the CLI phases: full-width R101 on small on-disk sets at 128x256
CLI_SIZE = ["--base_size", "256,128", "--crop_size", "256,128"]
CLI_COMMON = ["--batch_size", "2", "--num_workers", "4", "--tqdm", "false"]

# a COUNTERS entry read as bf16_launches - conv2_tc_launches
CONV2_FMA = "bf16_launches - conv2_tc_launches"
# the launch count of every kernel, by the name it has in the kernels line
COUNTERS = {
    "fused_bottleneck": (fused_bottleneck, "launches"),
    "fused_bottleneck_emit": (fused_bottleneck_emit, "launches"),
    # the masked-canvas launches among those two counts
    "fused_bottleneck_masked": (fused_bottleneck, "masked_launches"),
    "fused_bottleneck_emit_masked": (fused_bottleneck_emit, "masked_launches"),
    # the bf16 instances' launches among them
    "fused_bottleneck_bf16": (fused_bottleneck, "bf16_launches"),
    "fused_bottleneck_emit_bf16": (fused_bottleneck_emit, "bf16_launches"),
    # the bf16 launches whose plan left conv2 off wgmma (bf16_launches less
    # conv2_tc_launches): 0 on every path, so every exact launch check holds
    # conv2_tc_launches to bf16_launches
    "fused_bottleneck_bf16_conv2_fma": (fused_bottleneck, CONV2_FMA),
    "fused_bottleneck_emit_bf16_conv2_fma": (fused_bottleneck_emit, CONV2_FMA),
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
        setattr(fn, "conv2_tc_launches" if attr == CONV2_FMA else attr, 0)


def read_counts() -> dict[str, int]:
    return {name: fn.bf16_launches - fn.conv2_tc_launches if attr == CONV2_FMA
            else getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


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
        **_host_facts(),
    }
    emit(env)
    return env


def _host_facts() -> dict:
    """What the host data path builds on: the CPU count, the Pillow version
    (the extension's blur is held to it), whether g++ is there and
    preprocesses libpng's, zlib's and Python's headers (the extension needs
    the last two), whether the ``grain`` package imports (in a child
    process: it may pull in JAX, which this script never imports)."""
    gpp = shutil.which("g++")

    def header(name):
        if gpp is None:
            return None
        return subprocess.run([gpp, "-E", "-x", "c++", "-", "-o", os.devnull],
                              input=f"#include <{name}>\n", capture_output=True,
                              text=True).returncode == 0

    from PIL import __version__ as pillow

    grain = subprocess.run([sys.executable, "-c", "import grain"], capture_output=True,
                           text=True, timeout=120)
    return {"cpu_count": os.cpu_count(), "pillow": pillow, "gpp": gpp,
            "png_h": header("png.h"),
            "python_h": os.path.exists(os.path.join(sysconfig.get_paths()["include"], "Python.h")),
            "zlib_h": header("zlib.h"), "grain_imports": grain.returncode == 0,
            "grain_error": grain.stderr.strip().splitlines()[-1:] if grain.returncode else []}


def phase_build() -> None:
    """One nvcc per library, all started together: each source once, the
    fused bottleneck twice (its fp32 and, with -DMSL_BF16, its bf16
    instances, each a library of its own)."""
    t0 = time.perf_counter()
    bf16_defines = fused_block.INSTANCES[BF16][0]
    builds = {"fused_bottleneck.cu (fp32)": (fused_block.SOURCE, ()),
              "fused_bottleneck.cu (bf16)": (fused_block.SOURCE, bf16_defines),
              "fused_loss.cu": (fused_loss.SOURCE, ()),
              "matmul_probe.cu": (matmul_probe.SOURCE, ())}

    def timed_build(job):
        lib = kernel_build.build(*job)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(timed_build, builds.values()))
    for module in (fused_loss, matmul_probe):
        module._library()
    for dtype in fused_block.INSTANCES:
        fused_block._library(dtype)
    usage = {name: _resource_usage(lib) for name, (lib, _) in zip(builds, built)
             if name.startswith("fused_bottleneck")}
    emit({"phase": "build", "libraries": [lib.name for lib, _ in built],
          "seconds_by_library": {name: sec for name, (_, sec) in zip(builds, built)},
          "seconds": time.perf_counter() - t0, "resource_usage": usage})
    _check_no_spill(usage["fused_bottleneck.cu (bf16)"], "bf16")


def _check_no_spill(usage: dict | None, what: str) -> None:
    """Every instance of a bottleneck library without stack or local bytes:
    a spill of the bf16 instances' accumulators (conv2's 128 a thread at
    layer4) would put the wgmma products through local memory."""
    check(usage is not None, f"{what} bottleneck: no resource usage (cuobjdump missing)")
    spills = {name: u for name, u in usage.items() if u["stack_bytes"] or u["local_bytes"]}
    check(not spills, f"{what} bottleneck instances spill: {spills}")


def phase_hostops() -> None:
    """The host extension on this machine (``experiments/host_data.py``):
    build, decode matrix and blur draws against this machine's PIL, the
    fused routes against the general path, per-sample host ms. Fails where
    the extension cannot be built here or any check disagrees."""
    from maxsquareloss_torch.data import hostops
    from maxsquareloss_torch.experiments import host_data

    check(hostops.available(), "the host extension cannot be built here (no g++ or no zlib.h): "
                               "the loader would decode through PIL")
    work = tempfile.mkdtemp(prefix="chip_smoke_hostops_")
    try:
        ok = host_data.run(work, lambda obj: emit({"phase": "hostops", **obj}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(ok, "hostops: the extension disagrees with PIL or a fused route with the general "
              "path (see the hostops lines)")


def _resource_usage(lib) -> dict | None:
    """Each kernel instance's registers a thread and stack frame (spills and
    local arrays, bytes) in a built library, as ``cuobjdump
    --dump-resource-usage`` from the toolkit beside nvcc reads them; None
    where the tool is missing."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "--dump-resource-usage", str(lib)], capture_output=True,
                          text=True).stdout
    usage = {}
    for name, reg, stack, local in re.findall(
            r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", dump):
        if "fused_bottleneck_kernel" in name:  # <Emit>: its template argument
            name = "fused_bottleneck_kernel" + ("<emit>" if "ILb1E" in name else "<eval>")
        usage[name] = {"registers": int(reg), "stack_bytes": int(stack), "local_bytes": int(local)}
    return usage


def _block_inputs(gen, n, h, w, cin, cmid, dtype=torch.float32):
    """x and the HWIO kernels in ``dtype``, the BN vectors fp32."""
    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = randn(n, h, w, cin).relu().permute(0, 3, 1, 2).to(dtype)  # post-ReLU, channels_last
    w1 = randn(1, 1, cin, cmid, std=math.sqrt(2.0 / cmid)).to(dtype)
    w2 = randn(3, 3, cmid, cmid, std=math.sqrt(2.0 / (9 * cmid))).to(dtype)
    w3 = randn(1, 1, cmid, cin, std=math.sqrt(2.0 / cin)).to(dtype)
    bn = []
    for c, scale in ((cmid, None), (cmid, None), (cin, 0.1)):
        s = (torch.full((c,), scale) if scale is not None
             else torch.rand(c, generator=gen) + 0.5).cuda()
        bn += [s, randn(c, std=0.1)]
    return (x, w1, w2, w3, *bn)


def _tile_report(n, h, w, cin, cmid, d, dtype=torch.float32) -> dict:
    """The planner's tile for one shape in ``dtype``: its fields, the shared
    memory with the weight and x stages, the FLOP per byte of L2 weight
    traffic (a block reads every weight once per output row of its strip)
    and the threads that own pixels in each conv."""
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused_block.plan_tiles(n, h, w, cin, cmid, d, sm_count, dtype)
    return {"tile": plan._asdict(), "smem_bytes_with_stages": plan.smem,
            "conv_routes": plan.conv_routes(), "conv2_tile": plan.conv2_tile(cmid),
            "m_rows_used": plan.m_rows_used(d),
            "flop_per_l2_weight_byte": plan.flop_per_l2_weight_byte(dtype.itemsize),
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

    def recording_kernel(x, *args):  # args: w1..b3, dilation, valid
        n, cin, h, w = x.shape
        seen.add((n, h, w, cin, args[0].shape[-1], args[9]))
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


def _hold_emit(gen, name, n, h, w, cin, cmid, d, valid=None) -> tuple[tuple, tuple, dict]:
    """One shape's inputs, the emit kernel's (out, h1, h2), and its errors
    against the plain version (masked by ``valid``, if given)."""
    args = _block_inputs(gen, n, h, w, cin, cmid)
    got = fused_bottleneck_emit(*args, d, valid)
    want = fused_bottleneck_emit_reference(*args, d, valid)
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


def _train_pairs(dev="cuda"):
    def batches(hw, seed):
        ds = SyntheticSegDataset(length=2 * TRAIN_BATCH, hw=hw, seed=seed)
        return [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
                for x, y, _ in uint8_batches(ds, TRAIN_BATCH)]

    return [(xs, ys, xt) for (xs, ys), (xt, _) in zip(batches(SRC_HW, 3), batches(TGT_HW, 4))]


def _counted_steps(name, step, state, pairs, indices, per_step, timed=()):
    """Steps ``indices`` of a run (step i on pair ``i % len(pairs)``), each
    with exact launch counts ``per_step``; the steps in ``timed`` timed.
    Returns (state, metrics a step, seconds)."""
    metrics, secs = [], []
    for i in indices:
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *pairs[i % len(pairs)])
        torch.cuda.synchronize()
        if i in timed:
            secs.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in read_counts().items()}
        want = {k: per_step.get(k, 0) for k in delta}
        check(delta == want, f"{name} step {i}: launches {delta}, expected {want}")
        metrics.append({k: v.item() for k, v in m.items()})
    return state, metrics, secs


def _rates(secs, images) -> dict:
    """Steps/s and images/s (``images`` a step) of timed steps: median, min, max."""
    rates = sorted(1.0 / s for s in secs)
    return {"seconds": secs, "steps_per_s_median": statistics.median(rates),
            "steps_per_s_min": rates[0], "steps_per_s_max": rates[-1],
            "images_per_s_median": images * statistics.median(rates),
            "images_per_s_min": images * rates[0], "images_per_s_max": images * rates[-1]}


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
    emit({"phase": "train_parity", "metrics": {k: v.item() for k, v in m_k.items()},
          **_parity("train parity, kernel vs plain", m_k, model, m_p, plain, p0)})
    del plain, m_p
    torch.cuda.empty_cache()

    # record the shape of every emit launch on the main path
    seen = set()

    def recording(x, *args):  # args: w1..b3, dilation, valid
        n, cin, h, w = x.shape
        seen.add((n, h, w, cin, args[0].shape[-1], args[9]))
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
    n_iw = WARMUP_STEPS + REPS
    state, metrics, secs = _counted_steps("IW_maxsquare", step, state, pairs, range(n_iw),
                                          per_step["IW_maxsquare"], range(WARMUP_STEPS, n_iw))
    state, last, _ = _counted_steps("maxsquare", ms_step, state, pairs, range(n_iw, n_iw + 1),
                                    per_step["maxsquare"])
    metrics += last
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    model.train_block_fn = FusedBottleneckFn.apply

    check(seen <= emit_checked, f"emit kernel launched at unchecked shapes {sorted(seen - emit_checked)}")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()), f"train step {i}: non-finite metrics {m}")
    unmoved = [name for name, p in model.named_parameters() if torch.equal(p.detach(), p_start[name])]
    check(not unmoved, f"parameters that did not move: {unmoved[:5]}")
    rates = _rates(secs, 2 * TRAIN_BATCH)
    emit({"phase": "train", "run": "uda_IW_maxsquare_r101", "iw_hist": cfg.iw_hist,
          "batch": TRAIN_BATCH,
          "source_hw": list(SRC_HW), "target_hw": list(TGT_HW), "warmup": WARMUP_STEPS,
          "reps": REPS, **rates,
          "peak_memory_bytes": peak, "peak_memory_gib": peak / 2**30,
          "launch_counts": counts, "launch_shapes": sorted(seen),
          "first_metrics": metrics[0], "last_iw_metrics": metrics[-2],
          "maxsquare_metrics": metrics[-1]})
    phase_profile("train_step", lambda: step(state, *pairs[0]), top_n=16)
    return counts, rates["steps_per_s_median"]


def phase_concat_kernels() -> tuple[set, dict]:
    """The masked-canvas mode of both bottleneck kernels at each identity
    block shape of the concat step (N 8 on the canvas, 4 images valid over
    all of it and 4 over the target's extents) against the masked plain
    version (rtol = atol = 1e-4); the emitted h1 exactly 0 in the pad region;
    a second call the same bits; each timed beside the unmasked kernel at the
    same shape. Returns the checked shapes and the kernels-line entry of the
    masked emit kernel (times per concat step)."""
    gen = torch.Generator().manual_seed(6)
    masks = make_canvas_masks(CANVAS_HW, CANVAS_GROUPS, "cuda")
    rows, checked = [], set()
    for name, n, h, w, cin, cmid, d, per_fwd in CONCAT_SHAPES:
        valid = masks["os4" if name == "layer1" else "os8"].valid
        extents = valid.tolist()
        args, got, row = _hold_emit(gen, name, n, h, w, cin, cmid, d, valid)
        pad = (valid_mask(valid, h, w) == 0).expand_as(got[1])
        h1_pad_max = got[1][pad].abs().max().item()
        check(h1_pad_max == 0.0, f"masked emit {name}: h1 is {h1_pad_max} in the pad region")
        check(bool((got[1][~pad] > 0).any()), f"masked emit {name}: h1 is 0 everywhere")
        check(all(torch.equal(a, b) for a, b in zip(got, fused_bottleneck_emit(*args, d, valid))),
              f"masked emit {name}: two calls differ (not bitwise deterministic)")
        del got
        out_e = fused_bottleneck(*args, d, valid)
        max_abs, worst = _worst(out_e, fused_bottleneck_reference(*args, d, valid))
        check(worst <= 1.0, f"masked eval {name}: {max_abs:.3g} abs, {worst:.3g}x the tolerance")
        check(torch.equal(out_e, fused_bottleneck(*args, d, valid)),
              f"masked eval {name}: two calls differ (not bitwise deterministic)")
        del out_e

        def emit_k(v=valid):
            return fused_bottleneck_emit(*args, d, v)

        def eval_k(v=valid):
            return fused_bottleneck(*args, d, v)

        def plain():
            return fused_bottleneck_emit_reference(*args, d, valid)

        @torch.no_grad()
        def eval_plain():  # the eval path runs without grad
            return fused_bottleneck_reference(*args, d, valid)

        def unmasked(f):
            return lambda: f(None)

        p1, q1, e1, u1, v1, w1, e2, u2, v2, w2, q2, p2 = (time_ms(f, 5) for f in (
            plain, eval_plain, emit_k, unmasked(emit_k), eval_k, unmasked(eval_k),
            emit_k, unmasked(emit_k), eval_k, unmasked(eval_k), eval_plain, plain))
        torch.backends.cudnn.allow_tf32 = True  # cuDNN at PyTorch's defaults
        lib_ms, eval_lib_ms = time_ms(plain, 5), time_ms(eval_plain, 5)
        torch.backends.cudnn.allow_tf32 = False
        valid_px = sum(vh * vw for vh, vw in extents)
        flops, nbytes = _block_work(n, h, w, cin, cmid, True, valid_px)
        eval_flops, eval_bytes = _block_work(n, h, w, cin, cmid, False, valid_px)
        row.update({
            "valid_extents": sorted({tuple(e) for e in extents}), "valid_pixel_share": valid_px / (n * h * w),
            "h1_pad_max_abs": h1_pad_max, "bitwise_repeatable": True,
            "eval_max_abs_err": max_abs, "eval_worst_over_tol": worst,
            "per_forward": per_fwd, "ms": (e1 + e2) / 2, "unmasked_ms": (u1 + u2) / 2,
            "eval_ms": (v1 + v2) / 2, "eval_unmasked_ms": (w1 + w2) / 2,
            "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
            "eval_plain_ms": (q1 + q2) / 2, "eval_library_ms": eval_lib_ms,
            "bound_ms": max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "eval_bound_ms": max(eval_flops / PEAK_FP32_FLOPS, eval_bytes / PEAK_BYTES) * 1e3,
            "tflops": flops / ((e1 + e2) / 2) / 1e9,
        })
        emit({"phase": "concat_kernel", "kernel": "fused_bottleneck_emit_masked", **row})
        rows.append(row)
        checked.add((n, h, w, cin, cmid, d))
        del args
    torch.cuda.empty_cache()

    def per_step(key):  # one canvas forward a step
        return sum(r[key] * r["per_forward"] for r in rows)

    emit({"phase": "concat_kernel_summary", "blocks_per_step": sum(r["per_forward"] for r in rows),
          **{f"{k}_per_step": per_step(k) for k in (
              "ms", "unmasked_ms", "eval_ms", "eval_unmasked_ms", "plain_ms", "library_ms",
              "eval_plain_ms", "eval_library_ms", "bound_ms", "eval_bound_ms")}})
    return checked, {
        "name": "fused_bottleneck_emit_masked", "route": "cuda",
        "source": "maxsquareloss_torch/csrc/fused_bottleneck.cu",
        "replaces": "experiments/retired_pallas/fused_block.py:153",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(max(r["eval_max_abs_err"],
                               *(r[f"{k}_max_abs_err"] for k in ("out", "h1", "h2")))
                           for r in rows),
        # times and bound: the 29 identity blocks of one concat step
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"), "bound_by": "operations",
        "library_ms": per_step("library_ms"),
        "library": "the plain F.conv2d chain with the mask multiply, cuDNN at PyTorch "
                   "defaults (TF32 convs)",
        "shapes": rows,
    }


def _parity(name, m_k, model, m_ref, ref_model, p0, limits=(STEP_RTOL, STEP_PARAM_RTOL_L2),
            m_fp32=None) -> dict:
    """One step's metrics (relative ``limits[0]``; with ``m_fp32``, the
    metrics of the fp32 step from the same weights, the BF16_THRESHOLDED
    ones plus their distance from it: the bf16 limit) and every parameter's
    change (relative L2 ``limits[1]``) against a reference step's; the
    parameters fp32."""
    rtol, param_rtol = limits
    check(set(m_k) == set(m_ref), f"{name}: metrics {sorted(m_k)} vs {sorted(m_ref)}")
    check({p.dtype for p in model.parameters()} == {torch.float32}, f"{name}: parameters not fp32")
    metric_err, allowed = {}, {}
    for k in m_k:
        a, b = m_k[k].item(), m_ref[k].item()
        metric_err[k] = abs(a - b) / max(abs(b), 1e-30)
        allowed[k] = rtol
        if m_fp32 is not None and k in BF16_THRESHOLDED:
            allowed[k] += abs(b - m_fp32[k]) / max(abs(b), 1e-30)
        check(math.isfinite(a) and metric_err[k] <= allowed[k],
              f"{name} {k}: {a} vs {b}: rel {metric_err[k]:.3g} > {allowed[k]:.3g}")
    ref_params = dict(ref_model.named_parameters())
    param_err = {n: _rel_l2(p.detach() - p0[n], ref_params[n].detach() - p0[n])
                 for n, p in model.named_parameters()}
    worst = max(param_err, key=param_err.get)
    check(param_err[worst] <= param_rtol,
          f"{name}: {worst} change off by {param_err[worst]:.3g} (relative L2)")
    out = {"metric_rel_err": metric_err, "param_change_rel_l2_max": param_err[worst],
           "param_change_rel_l2_worst": worst,
           "param_change_rel_l2_median": statistics.median(param_err.values())}
    if m_fp32 is not None:
        out["metric_rel_allowed"] = allowed
    return out


def phase_concat(emit_checked: set, masked_checked: set) -> dict[str, int]:
    """The concat UDA step (--concat_batches) at the protocol's crops: one
    kernel-path concat step against one kernel-path two-forward step and
    one plain-path concat step from the same weights (PERF.md's training
    limits); then the counted main path, 2 warm-up and REPS timed steps of
    each, the two-forward steps first (each model's peak memory, the other
    model freed); last, a short UDATrainer with --concat_batches true
    --profile, whose trace must name the kernel. Returns the concat steps'
    launch counts."""
    cfg = CONCAT_CFG
    pairs = _train_pairs()
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device="cuda")
    two = DeepLabV2(model.cfg).to(device="cuda", memory_format=torch.channels_last)
    two.load_state_dict(model.state_dict())
    plain = DeepLabV2(model.cfg, plain_blocks=True).to(
        device="cuda", memory_format=torch.channels_last)
    plain.load_state_dict(model.state_dict())
    p0 = {name: p.detach().clone() for name, p in model.named_parameters()}
    concat_step, two_step = make_uda_train_step(cfg), make_uda_train_step(TRAIN_CFG)

    state, m_c = concat_step(make_train_state(model, cfg), *pairs[0])
    two_state, m_t = two_step(make_train_state(two, TRAIN_CFG), *pairs[0])
    with plain_losses():
        _, m_p = concat_step(make_train_state(plain, cfg), *pairs[0])
    emit({"phase": "concat_parity", "metrics": {k: v.item() for k, v in m_c.items()},
          "vs_two_forward_kernel_path": _parity("concat vs two-forward", m_c, model, m_t, two, p0),
          "vs_plain_path": _parity("concat kernel vs plain path", m_c, model, m_p, plain, p0)})
    del plain, m_p, p0
    torch.cuda.empty_cache()

    seen = {"concat": set(), "two_forward": set()}

    def recorder(key):
        def recording(x, *args):  # args: w1..b3, dilation, valid
            n, cin, h, w = x.shape
            seen[key].add((n, h, w, cin, args[0].shape[-1], args[9]))
            check((args[10] is not None) == (key == "concat"), f"{key}: masked launch mismatch")
            return FusedBottleneckFn.apply(x, *args)
        return recording

    loss_counts = {"fused_iw_max_square_loss": 1, "fused_iw_max_square_loss_backward": 1}
    runs = (("two_forward", two_step, {"fused_bottleneck_emit": 58, **loss_counts}),
            ("concat", concat_step, {"fused_bottleneck_emit": 29,
                                     "fused_bottleneck_emit_masked": 29, **loss_counts}))
    states = {"two_forward": two_state, "concat": state}
    results, counts = {}, {}
    for key, fn, per_step in runs:
        st = states.pop(key)
        st.model.train_block_fn = recorder(key)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_alloc = torch.cuda.memory_allocated()
        # the main path, counted: every launch from here to the read is the path's
        zero_counts()
        st, metrics, secs = _counted_steps(key, fn, st, pairs, range(WARMUP_STEPS + REPS),
                                           per_step, range(WARMUP_STEPS, WARMUP_STEPS + REPS))
        counts[key] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        for i, m in enumerate(metrics):
            check(all(math.isfinite(v) for v in m.values()), f"{key} step {i}: non-finite {m}")
        results[key] = {**_rates(secs, 2 * TRAIN_BATCH),
                        "peak_memory_bytes": peak, "peak_memory_gib": peak / 2**30,
                        "allocated_at_start_gib": start_alloc / 2**30,
                        "launch_counts": counts[key], "launch_shapes": sorted(seen[key]),
                        "last_metrics": metrics[-1]}
        st.model.train_block_fn = FusedBottleneckFn.apply
        if key == "two_forward":
            del st, two, two_state
            torch.cuda.empty_cache()
    check(seen["two_forward"] <= emit_checked,
          f"emit launched at unchecked shapes {sorted(seen['two_forward'] - emit_checked)}")
    check(seen["concat"] <= masked_checked,
          f"masked emit launched at unchecked shapes {sorted(seen['concat'] - masked_checked)}")
    emit({"phase": "concat", "run": "uda_IW_maxsquare_r101_concat", "iw_hist": cfg.iw_hist,
          "batch": TRAIN_BATCH, "source_hw": list(SRC_HW), "target_hw": list(TGT_HW),
          "canvas_hw": list(CANVAS_HW), "warmup": WARMUP_STEPS, "reps": REPS, **results,
          "concat_over_two_forward_steps_per_s": results["concat"]["steps_per_s_median"]
          / results["two_forward"]["steps_per_s_median"]})
    phase_profile("concat_train_step", lambda: concat_step(state, *pairs[0]), top_n=16)
    del state, model
    torch.cuda.empty_cache()
    phase_concat_trainer()
    return counts["concat"]


def phase_concat_trainer() -> None:
    """UDATrainer with --concat_batches true --profile over the trainer
    phase's in-memory loaders, TRAINER_ITERS iterations: 29 masked emit
    launches an iteration, and a torch.profiler trace of iterations 2-5
    under checkpoint_dir/profile that names the bottleneck kernel."""
    root = tempfile.mkdtemp(prefix="chip_smoke_concat_trainer_")
    try:
        cfg = dataclasses.replace(
            CONCAT_CFG, profile=True, iter_stop=TRAINER_ITERS, num_workers=8, tqdm=False,
            show_num_images=0, checkpoint_dir=os.path.join(root, "run"))
        model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device="cuda")
        src, tgt, _ = _trainer_loaders(cfg)
        trainer = UDATrainer(cfg, src, tgt, None, model=model)
        per_iter = {"fused_bottleneck_emit": 29, "fused_bottleneck_emit_masked": 29,
                    "fused_iw_max_square_loss": 1, "fused_iw_max_square_loss_backward": 1}
        _, counts, line = _counted_cli(
            "UDATrainer --concat_batches true --profile", trainer.train, None,
            {k: v * TRAINER_ITERS for k, v in per_iter.items()})
        check(trainer.state.iteration == TRAINER_ITERS, f"trainer ended at {trainer.state.iteration}")
        trace = trainer.profiler.path
        check(trace is not None and os.path.dirname(trace) == os.path.join(cfg.checkpoint_dir, "profile"),
              f"profile trace at {trace}")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0.0) + e.get("dur", 0.0)
        named = [k for k in kernels if "fused_bottleneck_kernel" in k]
        check(bool(named), "the profile trace names no fused_bottleneck_kernel")
        losses = _scalars(cfg.checkpoint_dir)["train/loss"]
        check(all(math.isfinite(r["value"]) for r in losses.values()), "non-finite trainer loss")
        ts = [losses[i]["ts"] for i in range(1, TRAINER_ITERS + 1)]
        top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:10]
        emit({"phase": "concat_trainer", **line, "iterations": TRAINER_ITERS,
              "trace": os.path.relpath(trace, root), "trace_bytes": os.path.getsize(trace),
              "trace_kernel_events": sum(1 for e in events if e.get("cat") == "kernel"),
              "trace_device_ms_iterations_2_5": sum(kernels.values()) / 1e3,
              "trace_top_kernels_ms": [{"name": k[:90], "ms": v / 1e3} for k, v in top],
              "steps_per_s_iterations_2_6_with_profiler":
                  statistics.median(1.0 / (b - a) for a, b in zip(ts[1:], ts[2:])),
              "losses": {i: r["value"] for i, r in losses.items()}})
        del trainer, model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _bf16_ulps(got, want) -> tuple[float, float]:
    """(max abs error, that error in bf16 ulps of ``want``'s largest
    magnitude: 8 significant bits)."""
    err = (got.float() - want.float()).abs().max().item()
    m = want.float().abs().max().item()
    return err, (err / 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else
                 (0.0 if err == 0 else math.inf))


def _block_work(n, h, w, cin, cmid, emit, conv1_pixels, itemsize=4) -> tuple[int, int]:
    """(FLOP, bytes) one masked launch needs: conv1 over ``conv1_pixels``
    (the valid ones: h1 is 0 elsewhere), conv2 and conv3 over every pixel;
    x read and out written once, h1 and h2 written with ``emit``, the
    weights read once, in elements of ``itemsize`` bytes; the BN vectors
    (fp32) read once."""
    px = n * h * w
    flops = 2 * (conv1_pixels * cin * cmid + px * (9 * cmid * cmid + cmid * cin))
    nbytes = (itemsize * (2 * px * (cin + (cmid if emit else 0)) + 2 * cin * cmid
                          + 9 * cmid * cmid) + 4 * (4 * cmid + 2 * cin))
    return flops, nbytes


def _hold_bf16(gen, name, n, h, w, cin, cmid, d, valid=None, timed=None) -> dict:
    """Both bf16 instances at one shape (masked by ``valid``) against their
    bf16 plain versions: the emit kernel's out, h1, h2 and the eval
    kernel's out within BF16_ULPS ulps of the plain version's largest
    magnitude, with the share of bitwise-equal elements; the eval out equal
    to the emit out; a second call of each the same bits; with ``valid``,
    h1 exactly 0 in the pad region. ``timed`` ("eval" or "emit"): that
    kernel timed beside its plain version (plain, kernel, kernel, plain),
    its bound at 989 TFLOP/s bf16 or 3.35 TB/s, and the FMA route's ceiling
    at 67 TFLOP/s. Returns the row."""
    args = _block_inputs(gen, n, h, w, cin, cmid, BF16)
    counts0 = read_counts()
    got = fused_bottleneck_emit(*args, d, valid)
    want = fused_bottleneck_emit_reference(*args, d, valid)
    out_e = fused_bottleneck(*args, d, valid)
    torch.cuda.synchronize()
    row = {"layer": name, "shape": [n, h, w, cin], "cmid": cmid, "dilation": d,
           "masked": valid is not None, **_tile_report(n, h, w, cin, cmid, d, BF16)}
    for label, a, b in zip(("out", "h1", "h2"), got, want):
        check(a.dtype == BF16 and bool(torch.isfinite(a).all()), f"bf16 {name} {label}: {a.dtype}")
        err, ulps = _bf16_ulps(a, b)
        check(ulps <= BF16_ULPS, f"bf16 {name} {label}: {err:.3g} abs, {ulps:.3g} ulps")
        row.update({f"{label}_max_abs_err": err, f"{label}_ulps": ulps,
                    f"{label}_bitwise_share": (a == b).float().mean().item()})
    check(torch.equal(out_e, got[0]), f"bf16 {name}: the eval out differs from the emit out")
    check(all(torch.equal(a, b) for a, b in zip(got, fused_bottleneck_emit(*args, d, valid)))
          and torch.equal(out_e, fused_bottleneck(*args, d, valid)),
          f"bf16 {name}: two calls differ (not bitwise deterministic)")
    row["bitwise_repeatable"] = True
    # each of the four launches above put conv2 on wgmma
    delta = {k: v - counts0[k] for k, v in read_counts().items()}
    row["conv2_tc_launches"] = {kernel: delta[f"{kernel}_bf16"] - delta[f"{kernel}_bf16_conv2_fma"]
                                for kernel in ("fused_bottleneck", "fused_bottleneck_emit")}
    check(row["conv2_tc_launches"] == {"fused_bottleneck": 2, "fused_bottleneck_emit": 2},
          f"bf16 {name}: conv2 on wgmma in {row['conv2_tc_launches']} of 2 launches each")
    if valid is not None:
        pad = (valid_mask(valid, h, w) == 0).expand_as(got[1])
        check(got[1][pad].abs().max().item() == 0.0, f"bf16 masked {name}: h1 is not 0 in the pad")
        row["h1_pad_max_abs"] = 0.0
    del got, want, out_e
    if timed:
        emit_k = timed == "emit"
        kernel_fn = fused_bottleneck_emit if emit_k else fused_bottleneck
        plain_fn = fused_bottleneck_emit_reference if emit_k else fused_bottleneck_reference

        def kernel():
            return kernel_fn(*args, d, valid)

        @torch.no_grad()
        def plain():
            return plain_fn(*args, d, valid)

        p1, k1, k2, p2 = (time_ms(f, 5) for f in (plain, kernel, kernel, plain))
        lib_ms = time_ms(plain, 5)
        flops, nbytes = _block_work(n, h, w, cin, cmid, emit_k, n * h * w, itemsize=2)
        ms = (k1 + k2) / 2
        row.update({
            "timed": timed, "ms": ms, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
            "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            "fma_ceiling_ms": flops / PEAK_FP32_FLOPS * 1e3, "tflops": flops / ms / 1e9,
        })
    del args
    return row


def phase_bf16_kernels() -> tuple[dict, list[dict]]:
    """The bf16 instances of the fused bottleneck (eval and emit) against
    their bf16 plain versions at every shape the bf16 paths launch them at:
    predict's TTA forwards and the batch-2 eval forward (eval timed), the
    bf16 UDA step's (emit timed), and the concat step's canvas, masked.
    Returns {kernel: checked (N, H, W, Cin, Cmid, d)} for both instances and
    their kernels-line entries (eval times per batch-2 forward, emit times
    per train step)."""
    gen = torch.Generator().manual_seed(7)
    masks = make_canvas_masks(CANVAS_HW, CANVAS_GROUPS, "cuda")
    runs = ([(s, None, None) for s in TTA_SHAPES] + [(s, None, "eval") for s in BLOCK_SHAPES]
            + [(s, None, "emit") for s in TRAIN_SHAPES]
            + [(s, masks["os4" if s[0] == "layer1" else "os8"].valid, None)
               for s in CONCAT_SHAPES])
    checked, rows, every = set(), {"eval": [], "emit": []}, []
    for (name, n, h, w, cin, cmid, d, per_fwd), valid, timed in runs:
        row = _hold_bf16(gen, name, n, h, w, cin, cmid, d, valid, timed)
        row["per_forward"] = per_fwd
        emit({"phase": "bf16_kernel", "kernel": "fused_bottleneck_bf16 (eval and emit)", **row})
        every.append(row)
        if valid is None:
            checked.add((n, h, w, cin, cmid, d))
        if timed:
            rows[timed].append(row)
    torch.cuda.empty_cache()
    worst = {key: max(r[f"{k}_{key}"] for r in every for k in ("out", "h1", "h2"))
             for key in ("max_abs_err", "ulps")}
    usage = _resource_usage(kernel_build.build(fused_block.SOURCE, fused_block.INSTANCES[BF16][0]))
    _check_no_spill(usage, "bf16")
    emit({"phase": "bf16_kernel_summary", "shapes": len(every), "max_abs_err": worst["max_abs_err"],
          "max_ulps": worst["ulps"],
          "min_bitwise_share": min(r[f"{k}_bitwise_share"] for r in every for k in ("out", "h1", "h2")),
          "conv2_tc_launches": {k: sum(r["conv2_tc_launches"][k] for r in every)
                                for k in ("fused_bottleneck", "fused_bottleneck_emit")},
          "resource_usage": usage})

    def entry(name, kind, per):
        rs = rows[kind]

        def total(key):  # the identity blocks of one eval forward or one train step
            return sum(r[key] * r["per_forward"] for r in rs)

        return {"name": name, "route": "cuda", "source": "maxsquareloss_torch/csrc/fused_bottleneck.cu",
                "replaces": "experiments/retired_pallas/fused_block.py:153",
                "launches": None,  # filled from the main path's run
                "max_abs_err": worst["max_abs_err"], "max_ulps": worst["ulps"],
                "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rs) else "bytes",
                "library_ms": total("library_ms"), "fma_ceiling_ms": total("fma_ceiling_ms"),
                "library": "the plain F.conv2d bf16 chain (cuDNN, channels_last), which is the "
                           "plain version", "per": per,
                # what runs each conv, by layer (the planner's choice; the same at
                # every shape of a layer)
                "conv_routes": {r["layer"]: r["conv_routes"] for r in rs},
                "shapes": rs}

    return ({"fused_bottleneck_bf16": set(checked), "fused_bottleneck_emit_bf16": set(checked)},
            [entry("fused_bottleneck_bf16", "eval", "the 29 blocks of a batch-2 1024x512 forward"),
             entry("fused_bottleneck_emit_bf16", "emit", "the 58 blocks of a train step")])


def phase_bf16(checked: dict) -> tuple[dict[str, int], dict[str, int]]:
    """The full-R101 bf16 UDA step (``--compute_dtype bfloat16``, the train
    phase's configuration): TRAJ_STEPS fp32 kernel-path steps from the
    seeded weights; then from the same weights one bf16 kernel-path step
    against one bf16 plain-path step (BF16_STEP_RTOL; BF16_THRESHOLDED
    beyond the fp32 step's distance; BF16_PARAM_RTOL_L2); the counted main path, the bf16 steps 2
    to TRAJ_STEPS (WARMUP_STEPS, REPS timed, the rest): 58 bf16 emit
    launches a step at checked shapes; the TRAJ_STEPS bf16 trajectory
    against the fp32 one; a profile of one step. Then ``evaluate`` and
    ``make_predict_fn`` in bf16 with the trained weights (argmax agreement
    with the fp32 path on the same weights; REPS timed drives, 29 bf16 eval
    launches a forward), and REPS concat steps in bf16 (29 masked bf16 emit
    launches a step). Returns the step's and the eval path's launch counts."""
    cfg = BF16_CFG
    pairs = _train_pairs()

    def seeded():
        return torch.Generator().manual_seed(0)

    model32 = init_deeplabv2(model_config(TRAIN_CFG), seeded(), device="cuda")
    state32, step32, traj32 = make_train_state(model32, TRAIN_CFG), make_uda_train_step(TRAIN_CFG), []
    for i in range(TRAJ_STEPS):
        state32, m = step32(state32, *pairs[i % len(pairs)])
        traj32.append({k: v.item() for k, v in m.items()})
    params32 = {n: p.detach().clone() for n, p in model32.named_parameters()}
    del state32, model32
    torch.cuda.empty_cache()

    model = init_deeplabv2(model_config(cfg), seeded(), device="cuda")
    plain = DeepLabV2(model.cfg, plain_blocks=True).to(device="cuda", memory_format=torch.channels_last)
    plain.load_state_dict(model.state_dict())
    p0 = {name: p.detach().clone() for name, p in model.named_parameters()}
    step = make_uda_train_step(cfg)
    state, m_k = step(make_train_state(model, cfg), *pairs[0])
    with plain_losses():
        _, m_p = step(make_train_state(plain, cfg), *pairs[0])
    emit({"phase": "bf16_parity", "metrics": {k: v.item() for k, v in m_k.items()},
          "metrics_fp32_step": traj32[0],
          "vs_plain_path": _parity("bf16 kernel vs plain path", m_k, model, m_p, plain, p0,
                                   BF16_LIMITS, traj32[0])})
    del plain, m_p
    torch.cuda.empty_cache()

    seen = set()

    def recording(x, *args):  # args: w1..b3, dilation, valid
        check(x.dtype == BF16, f"the bf16 step ran a block in {x.dtype}")
        n, cin, h, w = x.shape
        seen.add((n, h, w, cin, args[0].shape[-1], args[9]))
        return FusedBottleneckFn.apply(x, *args)

    model.train_block_fn = recording
    per_step = {"fused_bottleneck_emit": 58, "fused_bottleneck_emit_bf16": 58,
                "fused_iw_max_square_loss": 1, "fused_iw_max_square_loss_backward": 1}
    timed = range(1 + WARMUP_STEPS, 1 + WARMUP_STEPS + REPS)
    # the main path, counted: every launch from here to the read is the path's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, metrics, secs = _counted_steps("bf16", step, state, pairs, range(1, TRAJ_STEPS),
                                          per_step, timed)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    model.train_block_fn = FusedBottleneckFn.apply
    check(seen <= checked["fused_bottleneck_emit_bf16"],
          f"bf16 emit launched at unchecked shapes {sorted(seen - checked['fused_bottleneck_emit_bf16'])}")
    traj16 = [{k: v.item() for k, v in m_k.items()}, *metrics]
    check(all(math.isfinite(v) for m in traj16 for v in m.values()), "non-finite bf16 metrics")
    loss16 = np.array([m["loss"] for m in traj16])
    loss32 = np.array([m["loss"] for m in traj32])
    rel = np.abs(loss16 - loss32) / np.maximum(np.abs(loss32), 1e-3)
    flat16 = torch.cat([p.detach().flatten() for p in model.parameters()]).double()
    flat32 = torch.cat([params32[n].flatten() for n, _ in model.named_parameters()]).double()
    param_rel = ((flat16 - flat32).norm() / flat32.norm()).item()
    check(rel.max() < TRAJ_LOSS_MAX and rel.mean() < TRAJ_LOSS_MEAN,
          f"bf16 trajectory: loss off fp32 by {rel.max():.4g} max, {rel.mean():.4g} mean")
    check(param_rel < TRAJ_PARAM_RTOL_L2, f"bf16 trajectory: parameters off fp32 by {param_rel:.3g}")
    emit({"phase": "bf16", "run": "uda_IW_maxsquare_r101_bf16", "batch": TRAIN_BATCH,
          "source_hw": list(SRC_HW), "target_hw": list(TGT_HW), "warmup": WARMUP_STEPS,
          "reps": REPS, **_rates(secs, 2 * TRAIN_BATCH),
          "peak_memory_bytes": peak, "peak_memory_gib": peak / 2**30,
          "launch_counts": counts, "launch_shapes": sorted(seen),
          "trajectory_steps": TRAJ_STEPS, "trajectory_loss_rel_max": float(rel.max()),
          "trajectory_loss_rel_mean": float(rel.mean()), "trajectory_param_rel_l2": param_rel,
          "losses_bf16": loss16.tolist(), "losses_fp32": loss32.tolist()})
    phase_profile("bf16_train_step", lambda: step(state, *pairs[0]), top_n=16)
    del state, params32
    torch.cuda.empty_cache()

    eval_counts = _bf16_eval(model, checked["fused_bottleneck_bf16"])
    _bf16_concat(model)
    del model
    torch.cuda.empty_cache()
    return counts, eval_counts


def _bf16_eval(model, checked: set) -> dict[str, int]:
    """``evaluate`` (1024x512, 3 batches of 2) and ``make_predict_fn``
    (0.75,1.0 + flip) in bf16 on ``model``'s weights: argmax agreement of
    the bf16 logits and trainIds with an fp32 model on the same weights;
    then REPS timed drives of each, 29 bf16 eval launches a forward at
    checked shapes. Returns the drives' launch counts."""
    cfg = dataclasses.replace(TrainConfig(eval_h_chunk=-1), compute_dtype="bfloat16")
    fp32 = DeepLabV2(model_config(TrainConfig())).to(device="cuda", memory_format=torch.channels_last)
    fp32.load_state_dict(model.state_dict())
    ds = SyntheticSegDataset(length=3 * BATCH, hw=IMG_HW, seed=1)
    batches = list(uint8_batches(ds, BATCH))
    x0 = torch.from_numpy(batches[0][0]).cuda()
    with torch.inference_mode():
        xn, _ = _prepare_inputs(x0, None, cfg)
        logits16, logits32 = model(xn, aux=False)[1], fp32(xn, aux=False)[1]
    check(logits16.dtype == torch.float32 and bool(torch.isfinite(logits16).all()),
          f"bf16 logits {logits16.dtype}")
    pred16, pred32 = (make_predict_fn(c, m, PREDICT_SCALES, flip=True, out_hw=IMG_HW)(x0)
                      for c, m in ((cfg, model), (TrainConfig(), fp32)))
    agreement = {"logits_argmax": (logits16.argmax(-1) == logits32.argmax(-1)).float().mean().item(),
                 "predict_trainids": (pred16 == pred32).float().mean().item(),
                 "logits_max_abs_diff": (logits16 - logits32).abs().max().item(),
                 "logits_max_abs_fp32": logits32.abs().max().item()}
    del fp32, logits16, logits32, pred16, pred32
    torch.cuda.empty_cache()

    seen = set()
    block_fn = model.block_fn

    def recording(x, *args):
        n, cin, h, w = x.shape
        seen.add((n, h, w, cin, args[0].shape[-1], args[9]))
        return block_fn(x, *args)

    model.block_fn = recording
    predict = make_predict_fn(cfg, model, scales=PREDICT_SCALES, flip=True, out_hw=IMG_HW)
    valid = sum(int((y >= 0).sum()) for _, y, _ in batches)
    runs = (("evaluate_1024x512_bf16", lambda: evaluate(model, cfg, batches), len(ds), len(batches)),
            ("predict_ms_flip_bf16", lambda: predict(x0), BATCH, len(PREDICT_SCALES)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    lines = []
    for name, fn, images, forwards in runs:
        secs = []
        for _ in range(REPS):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            delta = {k: v - before[k] for k, v in read_counts().items()}
            want = {k: 29 * forwards if k in ("fused_bottleneck", "fused_bottleneck_bf16") else 0
                    for k in delta}
            check(delta == want, f"{name}: launches {delta}, expected {want}")
        if name.startswith("evaluate"):
            total = int(out["_eval"].confusion_matrix.sum())
            check(total == valid and math.isfinite(out["MIoU"]),
                  f"{name}: CM counts {total} of {valid}, mIoU {out['MIoU']}")
        else:
            check(out.shape == (BATCH, *IMG_HW) and bool(((out >= 0) & (out < 19)).all()),
                  f"{name}: trainIds {tuple(out.shape)}")
        rates = sorted(images / s for s in secs)
        lines.append({"run": name, "images": images, "forwards": forwards, "seconds": secs,
                      "images_per_s_median": statistics.median(rates),
                      "images_per_s_min": rates[0], "images_per_s_max": rates[-1]})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    model.block_fn = block_fn
    check(seen <= checked, f"bf16 eval launched at unchecked shapes {sorted(seen - checked)}")
    emit({"phase": "bf16_eval", "runs": lines, "agreement_with_fp32": agreement,
          "launch_counts": counts, "launch_shapes": sorted(seen),
          "peak_memory_gib": peak / 2**30})
    return counts


def _bf16_concat(model) -> None:
    """REPS bf16 steps with --concat_batches on ``model``'s weights: one
    canvas forward of 8 images a step, 29 masked bf16 emit launches."""
    cfg = dataclasses.replace(CONCAT_CFG, compute_dtype="bfloat16")
    pairs = _train_pairs()
    state, step = make_train_state(model, cfg), make_uda_train_step(cfg)
    per_step = {"fused_bottleneck_emit": 29, "fused_bottleneck_emit_bf16": 29,
                "fused_bottleneck_emit_masked": 29, "fused_iw_max_square_loss": 1,
                "fused_iw_max_square_loss_backward": 1}
    zero_counts()
    # one warm-up, REPS timed
    state, metrics, secs = _counted_steps("bf16 concat", step, state, pairs, range(1 + REPS),
                                          per_step, range(1, 1 + REPS))
    check(all(math.isfinite(v) for m in metrics for v in m.values()), "non-finite bf16 concat metrics")
    emit({"phase": "bf16_concat", "run": "uda_IW_maxsquare_r101_bf16_concat",
          "canvas_hw": list(CANVAS_HW), **_rates(secs, 2 * TRAIN_BATCH),
          "launch_counts": read_counts(), "last_metrics": metrics[-1]})


def phase_remat() -> None:
    """``--remat stages`` at full width, fp32 and bf16: one step without
    remat and one with from the same weights (parity at the kernel path's
    own limits: the train phase's in fp32, the bf16 phase's in bf16), each
    step's peak memory with only its own model resident; then WARMUP_STEPS
    and REPS timed remat steps, 116 emit launches a step (each identity
    block's forward runs again in the backward)."""
    pairs = _train_pairs()
    for dtype in ("float32", "bfloat16"):
        base = dataclasses.replace(TRAIN_CFG, compute_dtype=dtype)
        cfg = dataclasses.replace(base, remat="stages")
        ref = init_deeplabv2(model_config(base), torch.Generator().manual_seed(0), device="cuda")
        start = {k: v.clone() for k, v in ref.state_dict().items()}
        p0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
        peaks, metrics = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, metrics["plain"] = make_uda_train_step(base)(make_train_state(ref, base), *pairs[0])
        torch.cuda.synchronize()
        peaks["plain"] = torch.cuda.max_memory_allocated()
        for p in ref.parameters():  # only its parameters stay resident
            p.grad = None
        model = DeepLabV2(model_config(cfg)).to(device="cuda", memory_format=torch.channels_last)
        model.load_state_dict(start)
        del start
        torch.cuda.empty_cache()
        step = make_uda_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, metrics["remat"] = step(make_train_state(model, cfg), *pairs[0])
        torch.cuda.synchronize()
        peaks["remat"] = torch.cuda.max_memory_allocated()
        # both steps are kernel-path steps of one dtype: its limits, no fp32 allowance
        parity = _parity(f"remat vs no remat ({dtype})", metrics["remat"], model,
                         metrics["plain"], ref, p0,
                         (STEP_RTOL, STEP_PARAM_RTOL_L2) if dtype == "float32" else BF16_LIMITS)
        del ref
        torch.cuda.empty_cache()
        per_step = {"fused_bottleneck_emit": 116, "fused_iw_max_square_loss": 1,
                    "fused_iw_max_square_loss_backward": 1}
        if dtype == "bfloat16":
            per_step["fused_bottleneck_emit_bf16"] = 116
        zero_counts()
        state, ms, secs = _counted_steps(f"remat {dtype}", step, state, pairs,
                                         range(1, 1 + WARMUP_STEPS + REPS), per_step,
                                         range(1 + WARMUP_STEPS, 1 + WARMUP_STEPS + REPS))
        check(all(math.isfinite(v) for m in ms for v in m.values()), f"remat {dtype}: non-finite metrics")
        emit({"phase": "remat", "run": f"uda_IW_maxsquare_r101_{dtype}_remat_stages",
              "compute_dtype": dtype, "parity_vs_no_remat": parity,
              "peak_memory_gib_no_remat_step": peaks["plain"] / 2**30,
              "peak_memory_gib_remat_step": peaks["remat"] / 2**30,
              "peak_ratio": peaks["remat"] / peaks["plain"], **_rates(secs, 2 * TRAIN_BATCH),
              "launch_counts": read_counts()})
        del state, model
        torch.cuda.empty_cache()


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


def _trainer_loaders(cfg, val_groups: int | None = None):
    """In-memory synthetic source (1280x640), target (1024x512) and val
    (1024x512) loaders: one epoch of TRAINER_ITERS batch pairs, val 2
    batches of VAL_BATCH a data group (``val_groups`` of them: by default
    the run's); with several processes, this rank's data group's shard
    (``cfg.batch_size`` is global; under ``--sp`` every rank of a space
    group reads its group's)."""
    from maxsquareloss_torch.parallel import ddp, spatial

    group, groups = spatial.data_groups(cfg.sp)

    def loader(hw, n, seed, batch, train):
        return SegDataLoader(SyntheticSegDataset(length=n, hw=hw, seed=seed), batch_size=batch,
                             shuffle=train, num_workers=cfg.num_workers, seed=cfg.seed,
                             drop_last=train, pad_last=not train, shard_index=group,
                             shard_count=groups)

    val_groups = val_groups or groups
    n, batch = TRAINER_ITERS * cfg.batch_size, ddp.local_batch(cfg.batch_size, sp=cfg.sp)
    return (loader(SRC_HW, n, 3, batch, True), loader(TGT_HW, n, 4, batch, True),
            loader(TGT_HW, 2 * VAL_BATCH * val_groups, 5, VAL_BATCH * val_groups // groups,
                   False))


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


# int8 sites at R101's eval shapes (batch 2 at 1024x512): (name, kernel, Cin,
# Cout, stride, dilation, input H, W): the stem, a 1x1 at stride 1 and 2, the
# dilated 3x3 of layers 1, 3 and 4
INT8_SITES = (
    ("stem_7x7_s2", 7, 3, 64, 2, 1, 512, 1024),
    ("layer1_1x1_s1", 1, 256, 64, 1, 1, 129, 257),
    ("layer2_1x1_s2", 1, 256, 128, 2, 1, 129, 257),
    ("layer1_3x3_d1", 3, 64, 64, 1, 1, 129, 257),
    ("layer3_3x3_d2", 3, 256, 256, 1, 2, 65, 129),
    ("layer4_3x3_d4", 3, 512, 512, 1, 4, 65, 129),
)
BF16_EVAL_CFG = TrainConfig(eval_h_chunk=-1, compute_dtype="bfloat16")


def _int8_sites() -> list[dict]:
    """Each INT8_SITES site: the card's int8 product (``torch._int_mm``) of
    random int8 windows and weights against the plain int32 product of the
    same tensors on the CPU, bitwise; timed: the product alone, the whole
    int8 site in bf16 (quantize, windows, product, dequant) and the bf16
    cuDNN conv of the same shape."""
    from maxsquareloss_torch.models.layers import int8_matmul, int8_patches, qconv2d

    gen = torch.Generator().manual_seed(11)
    rows = []
    for name, k, cin, cout, stride, d, h, w in INT8_SITES:
        pad = d * (k // 2)
        xq = torch.randint(-127, 128, (BATCH, h, w, cin), generator=gen, dtype=torch.int8).cuda()
        wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8)
        w_mat = torch.nn.functional.pad(wq.permute(0, 2, 3, 1).reshape(cout, -1),
                                        (0, -(k * k * cin) % 8)).contiguous().cuda()
        cols = int8_patches(xq, k, stride, pad, d)
        a = cols.view(-1, cols.shape[-1])
        got = int8_matmul(a, w_mat)
        torch.cuda.synchronize()
        want = int8_matmul(a.cpu(), w_mat.cpu())
        check(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
              f"int8 {name}: the card's int32 product differs from the CPU's")
        x = (torch.randn(BATCH, cin, h, w, generator=gen) * 2).to(BF16).cuda().contiguous(
            memory_format=torch.channels_last)
        wf = torch.randn(cout, cin, k, k, generator=gen).to(BF16).cuda()
        oscale = torch.rand(cout, generator=gen).cuda() * 1e-3
        ainv = torch.tensor(40.0, device="cuda")
        with torch.no_grad():  # tens of microseconds each: medians of windows
            mm_ms = time_ms_median(lambda: int8_matmul(a, w_mat), 20)
            site_ms = time_ms_median(lambda: qconv2d(x, w_mat, oscale, ainv, k, stride, pad, d),
                                     20)
            bf16_ms = time_ms_median(
                lambda: torch.nn.functional.conv2d(x, wf, None, stride, pad, d), 20)
        m_rows, kk = a.shape
        rows.append({"site": name, "m": m_rows, "k": kk, "n": cout, "bitwise_equal": True,
                     "int_mm_ms": mm_ms, "int8_site_ms": site_ms, "bf16_cudnn_ms": bf16_ms,
                     "int_mm_tops": 2 * m_rows * kk * cout / mm_ms / 1e9})
        del xq, cols, a, got, want, x
    torch.cuda.empty_cache()
    return rows


def phase_int8() -> None:
    """int8 PTQ at the protocol: the site products bitwise (``_int8_sites``);
    then R101 in bf16 from seeded weights, calibrated (``quantize_from_loader``
    over the 3 eval batches, amax) and quantized, ``evaluate`` (1024x512, 3
    batches of 2) and predict (0.75,1.0 + flip) REPS times each beside the
    bf16 kernel path and the bf16 plain path (the cuDNN chain) on the same
    weights, in this call. The int8 path launches no fused kernel (its
    identity blocks run their int8 convs one by one); its trainIds against
    the plain path's are informational (random weights: near-ties).
    Calibration runs each identity block as the bf16 emit kernel (29
    launches a forward; its shapes are held after the phase). A profile of
    one evaluate batch of each path."""
    from maxsquareloss_torch.models.quantize import quantize_from_loader

    sites = _int8_sites()
    emit({"phase": "int8_sites", "sites": sites})
    cfg = BF16_EVAL_CFG
    model = init_deeplabv2(model_config(cfg, eval_mode=True), torch.Generator().manual_seed(0),
                           device="cuda")
    plain = DeepLabV2(model.cfg, plain_blocks=True).to(
        device="cuda", memory_format=torch.channels_last).eval()
    plain.load_state_dict(model.state_dict())
    ds = SyntheticSegDataset(length=3 * BATCH, hw=IMG_HW, seed=1)
    batches = list(uint8_batches(ds, BATCH))
    zero_counts()
    t0 = time.perf_counter()
    int8 = quantize_from_loader(cfg, model, batches)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib = {k: 0 for k in COUNTERS}  # one bf16 emit launch a block and batch
    calib.update(dict.fromkeys(("fused_bottleneck_emit", "fused_bottleneck_emit_bf16"),
                               29 * len(batches)))
    check(read_counts() == calib, f"calibration launches {read_counts()}, expected {calib}")
    check(int8.quantized and all(b.quantized for b in int8.layer3), "the int8 model has float sites")
    x0 = torch.from_numpy(batches[0][0]).cuda()
    valid = sum(int((y >= 0).sum()) for _, y, _ in batches)
    paths = (("bf16_kernel", model, 29), ("bf16_plain_cudnn", plain, 0), ("int8", int8, 0))
    lines, preds = [], {}
    for path, m, per_forward in paths:
        predict = make_predict_fn(cfg, m, PREDICT_SCALES, flip=True, out_hw=IMG_HW)
        for run, fn, images, forwards in (
                ("evaluate_1024x512", lambda: evaluate(m, cfg, batches), len(ds), len(batches)),
                ("predict_ms_flip", lambda: predict(x0), BATCH, len(PREDICT_SCALES))):
            fn()  # warm-up
            secs = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                want = {k: per_forward * forwards if k in ("fused_bottleneck", "fused_bottleneck_bf16")
                        else 0 for k in COUNTERS}
                check(read_counts() == want, f"int8 phase {path} {run}: {read_counts()}")
            if run.startswith("evaluate"):
                total = int(out["_eval"].confusion_matrix.sum())
                check(total == valid and math.isfinite(out["MIoU"]),
                      f"int8 phase {path}: CM counts {total} of {valid}, mIoU {out['MIoU']}")
            else:
                check(out.shape == (BATCH, *IMG_HW) and bool(((out >= 0) & (out < 19)).all()),
                      f"int8 phase {path}: trainIds {tuple(out.shape)}")
                preds[path] = out
            rates = sorted(images / t for t in secs)
            lines.append({"path": path, "run": run, "images": images, "seconds": secs,
                          "images_per_s_median": statistics.median(rates),
                          "images_per_s_min": rates[0], "images_per_s_max": rates[-1],
                          "kernel_launches_per_rep": per_forward * forwards})
    for path, m, _ in paths:  # where one evaluate batch's time goes, by path
        phase_profile(f"int8_phase_evaluate_batch_{path}", lambda: evaluate(m, cfg, batches[:1]),
                      top_n=10)
    with torch.inference_mode():
        xn, _ = _prepare_inputs(x0, None, cfg)
        logits = {p: m(xn, aux=False)[1] for p, m, _ in paths}
    ref = logits["bf16_plain_cudnn"]
    agreement = {p: {"predict_trainids_vs_plain": (preds[p] == preds["bf16_plain_cudnn"]).float()
                     .mean().item(),
                     "logits_argmax_vs_plain": (logits[p].argmax(-1) == ref.argmax(-1)).float()
                     .mean().item(),
                     "logits_max_abs_diff_vs_plain": (logits[p] - ref).abs().max().item()}
                 for p in ("bf16_kernel", "int8")}
    rate = {(ln["path"], ln["run"]): ln["images_per_s_median"] for ln in lines}
    emit({"phase": "int8", "calibration_seconds": calib_s, "runs": lines,
          "int8_over_bf16_kernel": {r: rate[("int8", r)] / rate[("bf16_kernel", r)]
                                    for _, r in rate},
          "int8_over_bf16_cudnn": {r: rate[("int8", r)] / rate[("bf16_plain_cudnn", r)]
                                   for _, r in rate},
          "agreement": agreement, "logits_max_abs_plain": ref.abs().max().item(),
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    del model, plain, int8, logits, preds
    torch.cuda.empty_cache()


def phase_export() -> None:
    """The serving export at the protocol: R101 from seeded weights saved as
    a ``.pth``, exported by ``tools.export_inference`` on the card at batch 2,
    512x1024, in bf16 (its default, bf16 parameters embedded) and in int8
    (calibrated on 4 synthetic PNGs). Each artifact is loaded in a fresh
    process by ``--load --selftest``, which must find it equal to the live
    graph rebuilt from the sidecar (exact); the bf16 artifact's forward must
    launch the fused kernel exactly 29 times, the int8 one never. Then, in
    this process, REPS forwards of each loaded artifact beside its live
    graph (images/s), the launches counted."""
    from PIL import Image

    from maxsquareloss_torch.optim import make_sgd
    from maxsquareloss_torch.tools import export_inference

    root = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        cfg = TrainConfig()
        model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device="cuda")
        ckpt = ckpt_lib.save_checkpoint(os.path.join(root, "ckpt"), model, make_sgd(model, cfg),
                                        0, 0, 0.0)
        del model
        for x, _, name in uint8_batches(SyntheticSegDataset(length=4, hw=IMG_HW, seed=3), 1):
            Image.fromarray(x[0]).save(os.path.join(root, f"calib_{name[0]}.png"))
        x = torch.from_numpy(next(uint8_batches(SyntheticSegDataset(length=BATCH, hw=IMG_HW,
                                                                    seed=4), BATCH))[0]).cuda()
        # export traces with fake tensors (no launch); the int8 export
        # calibrates on the 4 images, one bf16 emit launch a block each
        for tag, extra, per_forward, calib in (
                ("bf16", [], 29, {}),
                ("int8", ["--quantize", "int8", "--calib_images",
                          os.path.join(root, "calib_*.png")], 0,
                 {"fused_bottleneck_emit": 29 * 4, "fused_bottleneck_emit_bf16": 29 * 4})):
            base = os.path.join(root, f"serve_{tag}")
            argv = ["--pretrained_ckpt_file", ckpt, "--output", base, "--hw", ",".join(
                str(v) for v in IMG_HW), "--batch_size", str(BATCH)] + extra
            meta, _, line = _counted_cli("maxsquareloss_torch.tools.export_inference",
                                         lambda: export_inference.main(argv), None, calib)
            check((meta["compute_dtype"], meta["embed_dtype"], meta["quantize"]) == (
                "bfloat16", "bfloat16", "int8" if extra else ""), f"export {tag}: sidecar {meta}")
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, "-m", "maxsquareloss_torch.tools.export_inference", "--load",
                 base, "--selftest", "--pretrained_ckpt_file", ckpt],
                capture_output=True, text=True, timeout=600,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            selftest_s = time.perf_counter() - t0
            check(child.returncode == 0, f"export {tag}: --load --selftest failed:\n"
                  f"{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
            report = json.loads(child.stdout.strip().splitlines()[-1])
            check(report["selftest"] == "OK" and report["artifact_kernel_launches"] == per_forward,
                  f"export {tag}: selftest {report}, expected {per_forward} launches")

            art = torch.export.load(base + ".pt2").module()
            live_cfg = export_inference._cfg({**meta, "numpy_transform": True,
                                              "pretrained_ckpt_file": ckpt})
            live = export_inference.make_serving_fn(
                live_cfg, export_inference._model(live_cfg, "cuda", meta.get("calib_amax")),
                (1.0,), False, IMG_HW)
            rates = {}
            with torch.no_grad():
                check(torch.equal(art(x), live(x)), f"export {tag}: the artifact differs from "
                      "the live graph in this process")
                for name, fn in (("artifact", art), ("live", live)):
                    zero_counts()
                    ms = time_ms(lambda: fn(x), REPS)
                    launches = read_counts()["fused_bottleneck_bf16"]
                    check(launches == per_forward * (REPS + 1),
                          f"export {tag} {name}: {launches} bf16 eval launches in {REPS + 1} "
                          f"forwards, expected {per_forward} a forward")
                    rates[name] = {"ms_per_batch": ms, "images_per_s": BATCH / ms * 1e3}
            emit({"phase": "export", "artifact": tag, **line,
                  "artifact_mb": os.path.getsize(base + ".pt2") / 1e6,
                  "embed_dtype": meta["embed_dtype"], "selftest": report,
                  "selftest_seconds": selftest_s, "rates": rates})
            del art, live
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    seen = {f"{kernel}{suffix}": set() for kernel in ("fused_bottleneck", "fused_bottleneck_emit")
            for suffix in ("", "_bf16")}
    seen.update({name: set() for name in LOSSES})
    seen["fused_bottleneck_emit_masked"] = set()
    forward = Bottleneck.forward

    def recording_forward(self, x, kernel, train_kernel, mask=None):
        # int8 blocks run their convs one by one: no launch; calibration runs
        # the emit kernel
        if self.fusable and not self.quantized and kernel is fused_bottleneck:
            n, cin, h, w = x.shape
            emits = torch.is_grad_enabled() or model_layers._calib_recorder is not None
            key = "fused_bottleneck_emit" if emits else "fused_bottleneck"
            key += "_bf16" if x.dtype == BF16 else ""
            shape = (n, h, w, cin, self.conv1.out_channels, self.dilation)
            if mask is None:
                seen[key].add(shape)
            else:  # the sp concat leg's windows: held with their valid extents
                check(key == "fused_bottleneck_emit",
                      f"a masked {key} launch on a path whose shapes are held unmasked")
                seen["fused_bottleneck_emit_masked"].add(
                    (*shape, tuple(mask.valid.flatten().tolist())))
        return forward(self, x, kernel, train_kernel, mask)

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
        for shape in sorted(shapes - checked.setdefault(kernel, set())):
            if kernel.endswith("_bf16"):  # both bf16 instances at once
                row = _hold_bf16(gen, path, *shape)
                args = None
                for name in ("fused_bottleneck_bf16", "fused_bottleneck_emit_bf16"):
                    checked[name].add(shape)
            elif kernel == "fused_bottleneck":
                args, row = _hold_block(gen, path, *shape)
            elif kernel == "fused_bottleneck_emit":
                args, _, row = _hold_emit(gen, path, *shape)
            elif kernel == "fused_bottleneck_emit_masked":
                valid = torch.tensor(shape[6], dtype=torch.int32, device="cuda").view(-1, 2)
                args, _, row = _hold_emit(gen, path, *shape[:6], valid)
                row["valid_extents"] = valid.tolist()
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
    """The port's bench, in this process, in each mode at its default
    dtype (bf16) and again with ``--dtype float32``: its JSON on a line of
    its own, then the run's launch counts, each exact. ``uda`` is the JAX
    bench's default line: the bf16 step, bf16 inference and the fp32 parity
    leg (fp32, stage remat, batch 8: 116 fp32 emit launches a step); the
    fp32 lines run no parity leg and no remat. An int8 leg calibrates with
    one emit launch a block (the ``uda`` lines carry one). The e2e, ``uda
    --concat`` and ``source`` runs are bf16 only: their fp32 twins are not
    run, to keep the script in its time limit."""
    from maxsquareloss_torch import bench

    root = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    warmup, steps = 2, 5
    calls = warmup + 2 * steps  # warm-up, then two timed passes
    short = ["--steps", str(steps), "--warmup", str(warmup)]
    # e2e: 8 images a domain at batch 8 are 1 step an epoch; 4 legs of a
    # priming and a timed epoch, then 2 + 6 device-only steps
    e2e_steps = 4 * 2 * 1 + 8
    losses = {"fused_iw_max_square_loss": 1, "fused_iw_max_square_loss_backward": 1}

    def bf16(kernel, n):  # n bf16 launches of a bottleneck kernel
        return {kernel: n, f"{kernel}_bf16": n}

    fp32 = ["--dtype", "float32", *short]
    e2e = ["--n_per_domain", "8", "--epochs", "1", "--data_root", os.path.join(root, "data")]

    runs = (
        ("uda", ["--mode", "uda", *short],
         {**{k: 2 * v * calls for k, v in losses.items()},
          "fused_bottleneck_emit_bf16": 58 * calls + 29,
          "fused_bottleneck_emit": (58 + 116) * calls + 29, **bf16("fused_bottleneck", 29 * calls)}),
        # equal crops: one unmasked forward over 16 images a step
        ("uda_concat", ["--mode", "uda", "--concat", "--fp32_parity", "false",
                        "--with_infer", "false", *short],
         {**bf16("fused_bottleneck_emit", 29 * calls), **{k: v * calls for k, v in losses.items()}}),
        ("source", ["--mode", "source", *short], bf16("fused_bottleneck_emit", 29 * calls)),
        ("infer", ["--mode", "infer", *short], bf16("fused_bottleneck", 29 * calls)),
        ("infer_fullres_labels", ["--mode", "infer", "--label_hw", "1024,2048", *short],
         bf16("fused_bottleneck", 29 * calls)),
        # int8 backbone convs: no fused kernel (the identity blocks run their
        # int8 convs one by one) after the calibration's forward
        ("infer_int8", ["--mode", "infer", "--quantize", "int8", *short],
         bf16("fused_bottleneck_emit", 29)),
        ("e2e", ["--mode", "e2e", *e2e],
         {**bf16("fused_bottleneck_emit", 58 * e2e_steps),
          **{k: v * e2e_steps for k, v in losses.items()}}),
        # fp32: the step, inference and e2e without the parity leg
        ("uda_fp32", ["--mode", "uda", *fp32],
         {"fused_bottleneck_emit": 58 * calls + 29, "fused_bottleneck": 29 * calls,
          **{k: v * calls for k, v in losses.items()}}),
        ("infer_fp32", ["--mode", "infer", *fp32], {"fused_bottleneck": 29 * calls}),
        ("infer_fullres_labels_fp32", ["--mode", "infer", "--label_hw", "1024,2048", *fp32],
         {"fused_bottleneck": 29 * calls}),
    )
    try:
        for name, argv, expect in runs:
            result, _, line = _counted_cli("maxsquareloss_torch.bench", lambda: bench.main(argv),
                                           None, expect)
            check(result["value"] > 0, f"bench {name}: value {result['value']}")
            check(math.isfinite(result["extra"]["final_loss"]),
                  f"bench {name}: final_loss {result['extra']['final_loss']}")
            extra = result["extra"]
            if name.startswith("e2e"):
                calls = extra["hostops_calls"]
                check(extra["hostops"], f"bench {name}: the host extension did not serve every "
                                        f"decode of the cold and prepared legs: {calls}")
                check(calls["prepared_raw"]["decode"] == 0 and
                      all(c["blur"] > 0 for c in calls.values()),
                      f"bench {name}: a raw sidecar went through a PNG decode, or a leg "
                      f"blurred through PIL: {calls}")
            emit({"phase": "bench", "run": name, "argv": argv, "seconds": line["seconds"],
                  "metric": result["metric"], "value": result["value"],
                  "extra": {k: extra[k] for k in (
                      "value_bf16", "value_fp32", "value_fp32_parity", "fp32_global_batch",
                      "fp32_step_ms", "value_infer_bf16", "value_infer_int8",
                      "infer_int8_step_ms", "infer_step_ms", "quantize", "step_ms",
                      "peak_memory_bytes", "fp32_peak_memory_bytes", "e2e_cold_imgs_per_sec",
                      "e2e_warm_imgs_per_sec", "e2e_prepared_imgs_per_sec",
                      "e2e_prepared_raw_imgs_per_sec", "device_only_imgs_per_sec",
                      "hostops", "hostops_calls") if k in extra},
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


# --- the ddp phase ---------------------------------------------------------
# (a) two gloo ranks share the card (NCCL refuses two ranks on one device);
# (b) torchrun with NCCL over every card for the CLIs and the trainer; (c)
# the parity step and the step rate over the cards when there are several
HARD_CFG = dataclasses.replace(TRAIN_CFG, target_mode="hard")
DDP_SHARED_RANKS = 2
DDP_TIMEOUT_S = 420
DDP_TRAINER_GAP = 0.05  # the trainer's own limit (PERF.md section 2)


def _ddp_pairs(device) -> list[tuple]:
    """The parity steps' two global batches (4 + 4 images): the train
    phase's pairs; in the second, the upper half of the last two images'
    source labels is ignored, so the ranks' valid counts differ."""
    pairs = [tuple(t.to(device) for t in p) for p in _train_pairs()]
    xs, ys, xt = pairs[1]
    ys = ys.clone()
    ys[TRAIN_BATCH // 2:, : ys.shape[1] // 2] = -1
    pairs[1] = (xs, ys, xt)
    return pairs


def _ddp_steps(model, pairs, rows) -> tuple[list, dict, object]:
    """An IW_maxsquare step on the first global batch and a hard step on the
    second, each from the starting weights with a fresh optimizer, each on
    ``rows`` of its batch (DDP when a group of several exists): ([(metrics,
    parameters after) a step], the valid pixel counts of this rank's source
    labels and target labels, the train state)."""
    from maxsquareloss_torch.optim import make_sgd
    from maxsquareloss_torch.parallel import ddp

    state = make_train_state(model, TRAIN_CFG)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    counts = {"source": [], "target_label": []}
    guidance = train_steps.target_guidance

    def counted_guidance(*args):
        prob, label = guidance(*args)
        counts["target_label"].append(int((label != -1).sum()))
        return prob, label

    train_steps.target_guidance = counted_guidance
    out = []
    try:
        for cfg, (xs, ys, xt) in zip((TRAIN_CFG, HARD_CFG), pairs):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start[n])
            model.pack_weights()
            state.optimizer, state.iteration = make_sgd(model, cfg), 0
            counts["source"].append(int((ys[rows] != -1).sum()))
            state, m = make_uda_train_step(cfg)(state, xs[rows], ys[rows], xt[rows])
            out.append(({k: v.item() for k, v in m.items()},
                        {n: p.detach().cpu().clone() for n, p in model.named_parameters()}))
    finally:
        train_steps.target_guidance = guidance
    check(ddp.world() == 1 or state.ddp_loss is not None, "several ranks, but no DDP")
    return out, counts, state


def _median_step_s(step, state, pairs) -> float:
    """The median seconds of REPS UDA steps after WARMUP_STEPS, each fenced
    by ``torch.cuda.synchronize()`` (the global metrics of a DDP step also
    wait for every rank)."""
    secs = []
    for i in range(WARMUP_STEPS + REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *pairs[i % len(pairs)])
        float(m["loss"])
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


# the sp phase: --sp over ranks of one space group, each checked against the
# one-process kernel path on the same weights. Two gloo ranks share the card
# in the default run; --ddp-cards runs it over every card with NCCL (sp =
# cards, and dp2 x sp2 on four)
SP_SHARED_RANKS = 2
SP_DEVICE = "cuda:0"  # the shared card, where this process runs the references
SP_LABEL_HW = (1024, 2048)    # evaluate's step: 1024x512 images, 2048x1024 labels
SP_PREDICT_HW = (1024, 2048)  # predict: the 2048x1024 full-resolution input, batch 1
SP_MODEL_KW: dict = {}        # R101 (a dry run of the worker on the CPU shrinks it)
# compute dtype: (max |logit difference| over the largest |logit|, argmax
# agreement) against the one-process kernel path; fp32 also mIoU. In bf16
# the bound is that, or the one-process bf16 path's own distance from the
# fp32 path on the same weights where that is larger: a shard's convs (cuDNN
# picks its algorithm by shape) and the heads' product (cuBLAS, by rows)
# round some bf16 values the other way, and 33 blocks carry it on (read on
# an H100: 1.2e-2 of the largest logit, 2.4 bf16 ulps of it)
SP_LIMITS = {"float32": (1e-4, 0.999), "bfloat16": (1e-2, 0.99)}
SP_MIOU_TOL = 1e-4
# training under --sp: the UDA step (TRAIN_CFG) on the train phase's global
# batch, each data group its images and each rank its rows, against the
# one-process kernel-path step from the same weights (PERF.md section 2):
# fp32 at the n-rank limits, bf16 at the bf16 step's (the thresholded
# metrics beyond the fp32 step's distance from it); one parity step, a
# warm-up and SP_TRAIN_TIMED timed steps. Then UDATrainer --sp for
# SP_TRAINER_ITERS iterations and a validation against the one-process
# trainer: losses rel SP_TRAINER_RTOL, validation mIoU within SP_MIOU_TOL
SP_TRAIN_LIMITS = {"float32": (STEP_RTOL, STEP_PARAM_RTOL_L2), "bfloat16": BF16_LIMITS}
SP_TRAIN_TIMED = 2
# the training legs: name -> (compute dtype, config fields, timed steps). The
# fp32 step with --concat_batches (the masked canvas on row shards) and with
# --remat stages (whose exchanges must be exactly the fp32 step's) against
# their one-process steps at the fp32 limits
SP_TRAIN_LEGS = {"float32": ("float32", {}, SP_TRAIN_TIMED),
                 "bfloat16": ("bfloat16", {}, SP_TRAIN_TIMED),
                 "concat_float32": ("float32", {"concat_batches": True}, 1),
                 "remat_float32": ("float32", {"remat": "stages"}, 1)}
# the sharded serving export where the ranks are one space group: bf16 (the
# tool's default) at the JAX tool's --sp case, batch-1 full-resolution
# requests; each rank's artifact exact against its live --sp graph, the
# gathered map against the one-process bf16 artifact's at the bf16 --sp
# argmax limit (a shard's cuDNN algorithm rounds some bf16 values the other
# way: PERF.md section 2)
SP_EXPORT_HW = (1024, 2048)
SP_EXPORT_AGREE = SP_LIMITS["bfloat16"][1]
SP_TRAINER_ITERS = 2
SP_TRAINER_RTOL = 1e-4
# solve_gta5 --sp 2 over the cards (dp2 x sp2): its data groups' convs run
# at other batch sizes than the one process's, so a pixel within rounding of
# the guidance threshold may flip: one flip among the few hundred
# thresholded pixels of a 128x256 batch moves guidance_valid_frac and
# loss_target_aux by up to a few 1e-3 (PERF.md section 2)
SP_CLI_THRESHOLDED_RTOL = 1e-2


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, dev: torch.device, reps: int = 3) -> float:
    """The median wall ms of ``reps`` calls after one warm-up, each fenced
    (an exchange over gloo waits on the host anyway)."""
    fn()
    secs = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def _sp_expected_launches(model, in_hw, space) -> int:
    """The eval kernel's launches in one forward on this rank: one for each
    identity block whose map (os4 in layer1, os8 after) it owns rows of."""
    from maxsquareloss_torch.models.deeplabv2 import _valid_sizes

    sizes = _valid_sizes(in_hw)
    n = 0
    for i, layer in enumerate((model.layer1, model.layer2, model.layer3, model.layer4)):
        o0, o1 = space.own(sizes["os4" if i == 0 else "os8"][0])
        n += sum(b.fusable for b in layer) * (o1 > o0)
    return n


def _sp_case(dtype: str, space, dev: torch.device, data_group: int) -> tuple[dict, dict]:
    """One compute dtype on this rank of ``space``: the eval forward at
    1024x512, batch 2, evaluate's step over 2048x1024 labels, predict at
    2048x1024, batch 1, 0.75,1.0 + flip; each against the one-process kernel
    path on the same weights and inputs, its launches against the expected
    count. Returns (the readings, the launch shapes)."""
    from maxsquareloss_torch.metrics import Eval
    from maxsquareloss_torch.parallel import ddp, spatial
    from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step

    tol, agree_min = SP_LIMITS[dtype]
    cfg = TrainConfig(compute_dtype=dtype, **SP_MODEL_KW)
    model = init_deeplabv2(model_config(cfg, eval_mode=True), torch.Generator().manual_seed(0),
                           device=dev)
    x, y, _ = next(uint8_batches(SyntheticSegDataset(length=BATCH, hw=IMG_HW, seed=20 + data_group),
                                 BATCH, label_hw=SP_LABEL_HW))
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    h = IMG_HW[0]
    (a, b), (c, d) = space.own(h), space.own(y.shape[1])
    row = {"dtype": dtype}
    seen = {}

    def merge(shapes):
        for k, v in shapes.items():
            seen.setdefault(k, set()).update(v)

    # the forward: this rank's rows (sliced on the host) against the rows of
    # the one-process forward
    with torch.inference_mode():
        xn = _prepare_inputs(x.to(dev), None, cfg)[0]
        xs = _prepare_inputs(x[:, a:b].to(dev), None, cfg)[0]

        def one():
            return model(xn, aux=False)[1]

        def sharded():
            return model(xs, aux=False, space=space, in_h=h)[1]

        ref = one()
        bf16_vs_fp32 = None
        if dtype == "bfloat16":  # the same weights in fp32: bf16's own distance
            fp32 = init_deeplabv2(model_config(dataclasses.replace(cfg, compute_dtype="float32"),
                                               eval_mode=True), torch.Generator().manual_seed(0),
                                  device=dev)
            bf16_vs_fp32 = (ref - fp32(xn, aux=False)[1]).abs().max().item()
            del fp32
        _sync(dev)
        zero_counts()
        space.reset_stats()
        with recorded_shapes() as shapes:
            got = sharded()
            _sync(dev)
        merge(shapes)
        launches = read_counts()["fused_bottleneck"]
        halo = dict(space.stats)
        ms_one, ms_sp = _wall_ms(one, dev), _wall_ms(sharded, dev)
    o0, o1 = space.own(ref.shape[1])
    want = ref[:, o0:o1]
    scale = ref.abs().max().item()
    check(got.shape == want.shape, f"sp {dtype}: logits {tuple(got.shape)}, rows {o0}:{o1} "
                                   f"of {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"sp {dtype}: non-finite logits")
    err = (got - want).abs().max().item() if o1 > o0 else 0.0
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item() if o1 > o0 else 1.0
    expected = _sp_expected_launches(model, IMG_HW, space)
    limit = max(tol * scale, bf16_vs_fp32 or 0.0)
    row["forward"] = {
        "image_rows": [a, b], "logit_rows": [o0, o1], "max_abs_logit_diff": err,
        "max_abs_logit": scale, "diff_over_max_logit": err / scale, "limit": limit,
        "one_process_bf16_vs_fp32": bf16_vs_fp32, "argmax_agreement": agree,
        "eval_launches": launches, "expected_launches": expected,
        "halo_bytes_sent": halo["bytes_sent"], "halo_bytes_received": halo["bytes_received"],
        "exchanges": halo["exchanges"], "exchange_ms": halo["seconds"] * 1e3,
        "forward_ms_sp": ms_sp, "forward_ms_one_process": ms_one}
    check(err <= limit, f"sp {dtype}: logits off by {err:.3g} (max |logit| {scale:.3g}, limit "
                        f"{limit:.3g})")
    check(agree >= agree_min, f"sp {dtype}: argmax agrees on {agree:.5f}")
    check(launches == expected, f"sp {dtype}: {launches} eval launches, expected {expected}")
    del ref, got, want

    # evaluate's step: the matrices summed over every rank
    step1 = make_multiscale_eval_step(cfg, model)
    step_sp = make_multiscale_eval_step(cfg, model, space=space)
    cm1, arg1 = step1(x.to(dev), y.to(dev))
    zero_counts()
    cm_sp, arg_sp = step_sp(x[:, a:b].to(dev), y[:, c:d].to(dev), (h, y.shape[1]))
    _sync(dev)
    step_launches = read_counts()["fused_bottleneck"]
    step_agree = (arg_sp == arg1[:, c:d]).float().mean().item() if d > c else 1.0
    cm_sp = ddp.all_reduce_sum(cm_sp).cpu()
    cm1 = ddp.all_reduce_sum(cm1 if space.index == 0 else torch.zeros_like(cm1)).cpu()
    ev_sp, ev1 = Eval(NUM_CLASSES), Eval(NUM_CLASSES)
    ev_sp.add_confusion_matrix(cm_sp)
    ev1.add_confusion_matrix(cm1)
    miou_sp, miou1 = ev_sp.Mean_Intersection_over_Union(), ev1.Mean_Intersection_over_Union()
    step_ms = _wall_ms(lambda: step_sp(x[:, a:b].to(dev), y[:, c:d].to(dev), (h, y.shape[1])),
                       dev, reps=1)
    row["evaluate_step"] = {
        "label_rows": [c, d], "argmax_agreement": step_agree, "MIoU": miou_sp,
        "MIoU_one_process": miou1, "MIoU_diff": abs(miou_sp - miou1),
        "cm_total": int(cm_sp.sum()), "cm_total_one_process": int(cm1.sum()),
        "eval_launches": step_launches, "step_ms_sp": step_ms}
    check(int(cm_sp.sum()) == int(cm1.sum()), f"sp {dtype}: the matrices count "
                                              f"{int(cm_sp.sum())} pixels, not {int(cm1.sum())}")
    check(step_agree >= agree_min, f"sp {dtype}: evaluate's argmax agrees on {step_agree:.5f}")
    check(dtype != "float32" or abs(miou_sp - miou1) <= SP_MIOU_TOL,
          f"sp {dtype}: mIoU {miou_sp} against {miou1}")
    check(step_launches == expected, f"sp {dtype}: {step_launches} launches in evaluate's step")
    del cm1, arg1, cm_sp, arg_sp

    # predict at the full-resolution input, batch 1; rank 0 gathers the rows
    xp = torch.from_numpy(next(uint8_batches(
        SyntheticSegDataset(length=1, hw=SP_PREDICT_HW, seed=30 + data_group), 1))[0])
    hp = SP_PREDICT_HW[0]
    pa, pb = space.own(hp)
    pred1 = make_predict_fn(cfg, model, PREDICT_SCALES, True, SP_PREDICT_HW)(xp.to(dev))
    fn_sp = make_predict_fn(cfg, model, PREDICT_SCALES, True, SP_PREDICT_HW, space)
    zero_counts()
    space.reset_stats()
    with recorded_shapes() as shapes:
        pred_sp = fn_sp(xp[:, pa:pb].to(dev), hp)
        _sync(dev)
    merge(shapes)
    p_launches = read_counts()["fused_bottleneck"]
    p_halo = dict(space.stats)
    full = spatial.gather_rows(pred_sp, hp, space)
    p_expected = sum(_sp_expected_launches(model, (max(1, round(hp * s)),
                                                   max(1, round(SP_PREDICT_HW[1] * s))), space)
                     for s in PREDICT_SCALES)
    own_agree = (pred_sp == pred1[:, pa:pb]).float().mean().item() if pb > pa else 1.0
    row["predict"] = {
        "rows": [pa, pb], "own_rows_agreement": own_agree, "eval_launches": p_launches,
        "expected_launches": p_expected, "halo_bytes_sent": p_halo["bytes_sent"],
        "halo_bytes_received": p_halo["bytes_received"], "exchange_ms": p_halo["seconds"] * 1e3,
        "predict_ms_sp": _wall_ms(lambda: fn_sp(xp[:, pa:pb].to(dev), hp), dev, reps=1),
        "predict_ms_one_process": _wall_ms(
            lambda: make_predict_fn(cfg, model, PREDICT_SCALES, True, SP_PREDICT_HW)(xp.to(dev)),
            dev, reps=1)}
    check(pred_sp.shape == (1, pb - pa, SP_PREDICT_HW[1]), f"sp predict {tuple(pred_sp.shape)}")
    check(own_agree >= agree_min, f"sp {dtype}: predict agrees on {own_agree:.5f} of its rows")
    check(p_launches == p_expected, f"sp {dtype}: {p_launches} predict launches, "
                                    f"expected {p_expected}")
    if space.index == 0:
        gathered = (full == pred1).float().mean().item()
        row["predict"]["gathered_agreement"] = gathered
        check(full.shape == pred1.shape and gathered >= agree_min,
              f"sp {dtype}: gathered trainIds agree on {gathered:.5f}")
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row, seen


def _sp_train_cfg(dtype: str, sp: int = 1, **kw) -> TrainConfig:
    return dataclasses.replace(TRAIN_CFG, compute_dtype=dtype, sp=sp, **SP_MODEL_KW, **kw)


def _sp_train_run(cfg: TrainConfig, dev: torch.device, images: slice, space=None,
                  timed: int = SP_TRAIN_TIMED) -> dict:
    """The UDA step from the seeded weights on ``images`` of the train
    phase's global batches (``space``: this rank's rows of them): one step,
    counted, its shapes recorded, then a warm-up and ``timed`` timed steps.
    Returns its metrics and parameters after the first step, the first
    step's launches and halo, the timed ms and the peak memory."""
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device=dev)
    state, step = make_train_state(model, cfg, space), make_uda_train_step(cfg, space)
    pairs = [tuple(t[images] for t in p) for p in _train_pairs(dev)]
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    if space is not None:
        space.reset_stats()
    p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    with recorded_shapes() as shapes:
        state, m = step(state, *pairs[0])
        _sync(dev)
    out = {"metrics": {k: v.item() for k, v in m.items()}, "launches": read_counts(), "p0": p0,
           "halo": None if space is None else dict(space.stats), "shapes": shapes,
           "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()}}
    secs = []
    for i in range(1 + timed):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, *pairs[(i + 1) % len(pairs)])
        float(m["loss"])
        _sync(dev)
        if i:
            secs.append(time.perf_counter() - t0)
    out["step_ms"] = [t * 1e3 for t in secs]
    out["peak_memory_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                              if dev.type == "cuda" else None)
    if space is None:
        out["expected_emit"] = None
    elif cfg.concat_batches:  # one forward over the canvas
        out["expected_emit"] = _sp_expected_launches(model, CANVAS_HW, space)
    else:  # a forward of each batch, and under remat each again in the backward
        out["expected_emit"] = (1 + (cfg.remat == "stages")) * sum(
            _sp_expected_launches(model, hw, space) for hw in (SRC_HW, TGT_HW))
    del state, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _sp_train_case(leg: str, space, dev: torch.device, group: int, groups: int,
                   out: str) -> tuple[dict, dict]:
    """One training leg's SP step on this rank (``_sp_train_run`` on its
    data group's images): exact launches, every rank's parameters equal
    after it; rank 0 saves the metrics and parameters for the comparison.
    Returns (the readings, the launch shapes)."""
    from maxsquareloss_torch.parallel import ddp

    dtype, fields, timed = SP_TRAIN_LEGS[leg]
    per = TRAIN_BATCH // groups
    run = _sp_train_run(_sp_train_cfg(dtype, space.sp, **fields), dev,
                        slice(group * per, (group + 1) * per), space, timed)
    shapes, params = run.pop("shapes"), run.pop("params")
    del run["p0"]
    sums = torch.stack([p.double().sum() for p in params.values()])
    run["replicas_equal"] = bool((ddp.all_gather(sums) == sums).all())
    if ddp.is_main():
        torch.save({"metrics": run["metrics"], "params": params},
                   os.path.join(out, f"sp_train_{leg}.pt"))
    emits = run.pop("expected_emit")
    want = {k: 0 for k in COUNTERS}
    want.update({"fused_bottleneck_emit": emits, "fused_iw_max_square_loss": 1,
                 "fused_iw_max_square_loss_backward": 1})
    if dtype == "bfloat16":
        want["fused_bottleneck_emit_bf16"] = emits
    if fields.get("concat_batches"):  # unequal crops: every canvas launch is masked
        want["fused_bottleneck_emit_masked"] = emits
    check(run["launches"] == want, f"sp train {leg} rank {ddp.rank()}: launches "
                                   f"{run['launches']}, expected {want}")
    check(run["replicas_equal"], f"sp train {leg}: the ranks' parameters differ")
    return {"leg": leg, "dtype": dtype, "images": [group * per, (group + 1) * per], **run}, shapes


def _sp_trainer_cfg(out: str, sp: int = 1, **kw) -> TrainConfig:
    return dataclasses.replace(
        TRAIN_CFG, sp=sp, iter_stop=SP_TRAINER_ITERS, num_workers=4, tqdm=False,
        show_num_images=0, checkpoint_dir=out, **SP_MODEL_KW, **kw)


def _sp_trainer_case(space, dev: torch.device, out: str) -> dict:
    """``UDATrainer --sp`` over the trainer phase's in-memory loaders (this
    rank's data group's shard), SP_TRAINER_ITERS iterations and a
    validation; rank 0 writes the scalars under ``out``. Exact launches."""
    cfg = _sp_trainer_cfg(os.path.join(out, "sp_trainer"), space.sp, device=str(dev))
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device=dev)
    trainer = UDATrainer(cfg, *_trainer_loaders(cfg), model=model)
    zero_counts()
    space.reset_stats()
    t0 = time.perf_counter()
    trainer.train()
    _sync(dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    emits = sum(_sp_expected_launches(model, hw, space) for hw in (SRC_HW, TGT_HW))
    want = {"fused_bottleneck_emit": emits * SP_TRAINER_ITERS,
            "fused_bottleneck": 2 * _sp_expected_launches(model, TGT_HW, space),
            "fused_iw_max_square_loss": SP_TRAINER_ITERS,
            "fused_iw_max_square_loss_backward": SP_TRAINER_ITERS}
    got = {k: counts[k] for k in want}
    check(got == want, f"sp trainer: launches {got}, expected {want}")
    check(trainer.state.iteration == SP_TRAINER_ITERS, f"sp trainer at {trainer.state.iteration}")
    del trainer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"seconds": seconds, "launches": got, "halo": dict(space.stats)}


def _sp_export_input() -> torch.Tensor:
    """The selftest's seeded uint8 batch at SP_EXPORT_HW (batch 1)."""
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(1, *SP_EXPORT_HW, 3)).astype(np.uint8))


def _sp_export_argv(ckpt: str, base: str) -> list[str]:
    blocks = TrainConfig(**SP_MODEL_KW).blocks
    return ["--pretrained_ckpt_file", ckpt, "--output", base, "--hw",
            ",".join(map(str, SP_EXPORT_HW)), "--batch_size", "1", "--blocks",
            ",".join(map(str, blocks))]


def _sp_export_case(space, dev: torch.device, device: str, out: str) -> tuple[dict, dict]:
    """The sharded serving export on this rank (the ranks are one space
    group): ``tools.export_inference --sp`` of the seeded ``.pth`` that
    phase_sp wrote under ``out``, bf16; ``--load --selftest`` (exact, 29
    eval launches a forward on every rank); then this rank's artifact on
    its rows of the selftest's batch: the whole map (rank 0 saves it for
    the comparison with the one-process artifact), the halo bytes of that
    forward, and the artifact's ms beside its live graph's. Returns (the
    readings, the launch shapes)."""
    from maxsquareloss_torch.kernels.fused_block import fused_bottleneck
    from maxsquareloss_torch.tools import export_inference

    ckpt, base = os.path.join(out, "export_ckpt.pth"), os.path.join(out, "serve_sp")
    argv = _sp_export_argv(ckpt, base) + ["--sp", str(space.sp)] + (
        [] if device == "-" else ["--device", device])
    t0 = time.perf_counter()
    meta = export_inference.main(argv)
    export_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    report = export_inference.main(["--load", base, "--selftest", "--pretrained_ckpt_file",
                                    ckpt])
    selftest_s = time.perf_counter() - t0
    art = torch.export.load(os.path.join(out, meta["files"][space.index])).module()
    cfg = export_inference._cfg({**meta, "numpy_transform": True, "pretrained_ckpt_file": ckpt,
                                 "device": str(dev)})
    model = export_inference._model(cfg, dev)
    expected = _sp_expected_launches(model, SP_EXPORT_HW, space)
    check(report["selftest"] == "OK" and report["rank_artifact_kernel_launches"] == [
        expected] * space.sp, f"sp export: selftest {report}, expected {expected} launches "
                              "a forward on every rank")
    check(read_counts()["fused_bottleneck_bf16"] == 2 * expected,
          f"sp export: {read_counts()['fused_bottleneck_bf16']} bf16 eval launches in the "
          f"selftest's two forwards, expected {2 * expected}")
    model.drop_fused_conv_weights()
    live = export_inference.make_serving_fn(cfg, model, (1.0,), False, SP_EXPORT_HW, space,
                                            SP_EXPORT_HW[0])
    x = _sp_export_input()[:, slice(*meta["input_rows"][space.index])].to(dev)
    with torch.no_grad(), recorded_shapes() as shapes:
        space.reset_stats()
        got = art(x)
        _sync(dev)
        halo = dict(space.stats)
        check(torch.equal(got, live(x)), "sp export: the artifact differs from its live graph")
        check(tuple(got.shape) == (1, *SP_EXPORT_HW), f"sp export: output {tuple(got.shape)}")
        ms_art, ms_live = _wall_ms(lambda: art(x), dev), _wall_ms(lambda: live(x), dev)
    if space.index == 0:
        torch.save(got.cpu(), os.path.join(out, "sp_export_trainids.pt"))
    row = {"hw": list(SP_EXPORT_HW), "batch": 1, "sp": space.sp, "rank_rows":
           meta["input_rows"][space.index], "embed_dtype": meta["embed_dtype"],
           "export_seconds": export_s, "selftest_seconds": selftest_s,
           "artifact_mb": os.path.getsize(os.path.join(out, meta["files"][space.index])) / 1e6,
           "selftest": report, "eval_launches": report["artifact_kernel_launches"],
           "halo_bytes_sent": halo["bytes_sent"], "halo_bytes_received": halo["bytes_received"],
           "exchanges": halo["exchanges"], "exchange_ms": halo["seconds"] * 1e3,
           "ms_artifact": ms_art, "ms_live": ms_live,
           "images_per_s_artifact": 1e3 / ms_art, "images_per_s_live": 1e3 / ms_live}
    del art, live, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row, shapes


def _sp_worker(out: str, backend: str, device: str, sp: int) -> dict:
    """A rank of the sp phase: every case of ``SP_LIMITS``, every leg of
    ``SP_TRAIN_LEGS``, the trainer and (one space group) the export; writes
    ``sp_rank<r>.json`` under ``out`` (its readings and launch shapes)."""
    from maxsquareloss_torch.parallel import ddp, spatial

    ddp.init_distributed(backend)
    dev = resolve_device(None if device == "-" else device)
    space = spatial.space_group(sp)
    data_group, data_groups = spatial.data_groups(sp)
    cases, train, seen = [], [], {}

    def merge(shapes):
        for k, v in shapes.items():
            seen.setdefault(k, set()).update(v)

    for dtype in SP_LIMITS:
        row, shapes = _sp_case(dtype, space, dev, data_group)
        cases.append(row)
        merge(shapes)
    for leg in SP_TRAIN_LEGS:
        row, shapes = _sp_train_case(leg, space, dev, data_group, data_groups, out)
        train.append(row)
        merge(shapes)
    halo = {leg: {k: v for k, v in r["halo"].items() if "seconds" not in k}
            for leg, r in zip(SP_TRAIN_LEGS, train)}
    check(halo["remat_float32"] == halo["float32"],
          f"sp remat rank {ddp.rank()}: exchanges {halo['remat_float32']}, the step without "
          f"remat {halo['float32']}")
    trainer = _sp_trainer_case(space, dev, out)
    export = None
    if data_groups == 1:
        export, shapes = _sp_export_case(space, dev, device, out)
        merge(shapes)
    result = {"world": ddp.world(), "rank": ddp.rank(), "sp": sp, "space_index": space.index,
              "data_group": data_group, "data_groups": data_groups, "backend": backend,
              "device": str(dev), "cases": cases, "train": train, "trainer": trainer,
              "export": export, "launch_shapes": {k: sorted(v) for k, v in seen.items() if v}}
    with open(os.path.join(out, f"sp_rank{ddp.rank()}.json"), "w") as f:
        json.dump(result, f)
    return result


def _sp_train_parity(leg: str, ref: dict, got: dict, p0: dict, m_fp32: dict) -> dict:
    """The SP step's metrics and parameter changes against the one-process
    step's (SP_TRAIN_LIMITS by the leg's dtype; in bf16 the
    BF16_THRESHOLDED metrics beyond the one-process bf16 step's distance
    from the fp32 one, ``m_fp32``)."""
    dtype = SP_TRAIN_LEGS[leg][0]
    rtol, param_rtol = SP_TRAIN_LIMITS[dtype]
    report = _ddp_parity(p0, [(ref["metrics"], ref["params"])],
                         [(got["metrics"], got["params"])])[0]
    m_ref = ref["metrics"]
    allowed = {k: rtol + (abs(m_ref[k] - m_fp32[k]) / max(abs(m_ref[k]), 1e-30)
                          if dtype == "bfloat16" and k in BF16_THRESHOLDED else 0.0)
               for k in m_ref}
    bad = {k: v for k, v in report["metric_rel_err"].items() if not v <= allowed[k]}
    check(report["finite"] and not bad, f"sp train {leg}: metrics off {bad}")
    check(report["param_change_rel_l2_max"] <= param_rtol,
          f"sp train {leg}: {report['param_change_rel_l2_worst']} change off by "
          f"{report['param_change_rel_l2_max']:.3g} (relative L2)")
    return {**report, "metric_rel_allowed": allowed}


def _sp_trainer_reference(groups: int, dev: torch.device) -> dict:
    """The one-process UDATrainer over the same loaders (val images of
    ``groups`` data groups): its scalars."""
    root = tempfile.mkdtemp(prefix="chip_smoke_sp_trainer_")
    try:
        cfg = _sp_trainer_cfg(root, device=str(dev))
        model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device=dev)
        trainer = UDATrainer(cfg, *_trainer_loaders(cfg, val_groups=groups), model=model)
        trainer.train()
        del trainer, model
        return _scalars(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _sp_trainer_parity(work: str, ref: dict) -> dict:
    """Rank 0's scalars of ``UDATrainer --sp`` against the one-process
    trainer's: every loss rel SP_TRAINER_RTOL, the validation mIoU within
    SP_MIOU_TOL."""
    got = _scalars(os.path.join(work, "sp_trainer"))
    losses = {i: (got["train/loss"][i]["value"], r["value"])
              for i, r in ref["train/loss"].items()}
    check(sorted(got["train/loss"]) == sorted(ref["train/loss"]) == list(
        range(1, SP_TRAINER_ITERS + 1)), f"sp trainer loss steps {sorted(got['train/loss'])}")
    rel = {i: abs(a - b) / abs(b) for i, (a, b) in losses.items()}
    miou = (got["val/MIoU"][SP_TRAINER_ITERS]["value"],
            ref["val/MIoU"][SP_TRAINER_ITERS]["value"])
    check(max(rel.values()) <= SP_TRAINER_RTOL, f"sp trainer losses off by {rel}")
    check(abs(miou[0] - miou[1]) <= SP_MIOU_TOL, f"sp trainer mIoU {miou[0]} vs {miou[1]}")
    return {"losses": losses, "loss_rel_err": rel, "val_MIoU": miou[0],
            "val_MIoU_one_process": miou[1]}


def phase_sp(checked: dict, cards: int | None = None) -> dict[str, list[int]]:
    """Spatial partitioning (``--sp``) of the eval forward, evaluate's step
    and predict, and training (the UDA step in both dtypes and the
    trainer), each rank a process started by ``torchrun``: two gloo ranks
    on the one card, or (``cards``) NCCL over every card, sp = cards, and
    dp2 x sp2 on four. The one-process references run here first, on the
    same weights and global batches. Every shard shape a rank launched a
    kernel at is then held against the plain version. Returns each kernel's
    launches on the sp path by rank (the eval kernel's a forward, the
    training kernels' a step)."""
    me = os.path.abspath(__file__)
    dev = torch.device(SP_DEVICE)
    if cards is None:
        runs = [(SP_SHARED_RANKS, "gloo", SP_DEVICE, SP_SHARED_RANKS)]
    else:
        runs = [(cards, "nccl", "-", cards)] + ([(4, "nccl", "-", 2)] if cards == 4 else [])
    from maxsquareloss_torch.optim import make_sgd
    from maxsquareloss_torch.tools import export_inference

    refs = {}
    for leg, (dtype, fields, timed) in SP_TRAIN_LEGS.items():
        refs[leg] = _sp_train_run(_sp_train_cfg(dtype, **fields), dev, slice(None), timed=timed)
        del refs[leg]["shapes"], refs[leg]["expected_emit"], refs[leg]["halo"]
    p0 = refs["float32"]["p0"]
    for r in refs.values():  # the same seeded fp32 parameters
        del r["p0"]
    emit({"phase": "sp_train_one_process", "batch": TRAIN_BATCH,
          "source_hw": list(SRC_HW), "target_hw": list(TGT_HW),
          **{leg: {k: v for k, v in r.items() if k != "params"} for leg, r in refs.items()}})
    # the export's seeded .pth and the one-process bf16 artifact's map
    export_root = tempfile.mkdtemp(prefix="chip_smoke_sp_export_")
    cfg = TrainConfig(**SP_MODEL_KW)
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device=dev)
    export_ckpt = ckpt_lib.save_checkpoint(os.path.join(export_root, "ckpt"), model,
                                           make_sgd(model, cfg), 0, 0, 0.0)
    del model
    base = os.path.join(export_root, "serve_one")
    t0 = time.perf_counter()
    export_inference.main(_sp_export_argv(export_ckpt, base) + ["--device", str(dev)])
    with torch.no_grad():
        one_map = torch.export.load(base + ".pt2").module()(_sp_export_input().to(dev)).cpu()
    emit({"phase": "sp_export_one_process", "hw": list(SP_EXPORT_HW),
          "seconds": time.perf_counter() - t0,
          "artifact_mb": os.path.getsize(base + ".pt2") / 1e6})
    torch.cuda.empty_cache()
    trainer_refs = {}
    launches = {k: [] for k in ("fused_bottleneck", "fused_bottleneck_bf16",
                                "fused_bottleneck_emit", "fused_bottleneck_emit_bf16",
                                "fused_bottleneck_emit_masked", "fused_bottleneck_emit_remat",
                                "fused_bottleneck_bf16_export", "fused_iw_max_square_loss",
                                "fused_iw_max_square_loss_backward")}
    for nproc, backend, device, sp in runs:
        groups = nproc // sp
        if groups not in trainer_refs:
            trainer_refs[groups] = _sp_trainer_reference(groups, dev)
        work = tempfile.mkdtemp(prefix="chip_smoke_sp_")
        try:
            shutil.copy(export_ckpt, os.path.join(work, "export_ckpt.pth"))
            _torchrun(nproc, [me, "--ddp-worker", "sp", work, backend, device, str(sp)],
                      f"sp {sp} over {nproc} {backend} ranks")
            ranks = []
            for r in range(nproc):
                with open(os.path.join(work, f"sp_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            parity = {leg: _sp_train_parity(
                leg, refs[leg], torch.load(os.path.join(work, f"sp_train_{leg}.pt")), p0,
                refs["float32"]["metrics"]) for leg in SP_TRAIN_LEGS}
            trainer = _sp_trainer_parity(work, trainer_refs[groups])
            export = None
            if groups == 1:
                sp_map = torch.load(os.path.join(work, "sp_export_trainids.pt"))
                agree = (sp_map == one_map).float().mean().item()
                export = {"sp": sp, "world": nproc, "backend": backend,
                          "gathered_vs_one_process_artifact": agree,
                          "ranks": [r["export"] for r in ranks]}
                emit({"phase": "sp_export", **export})
                check(sp_map.shape == one_map.shape and agree >= SP_EXPORT_AGREE,
                      f"sp export: the gathered map agrees with the one-process bf16 "
                      f"artifact's on {agree:.5f}")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        seen = {}
        for rank in ranks:
            shapes = rank.pop("launch_shapes")
            emit({"phase": "sp", **rank})
            for k, v in shapes.items():  # a masked shape ends with its valid extents
                seen.setdefault(k, set()).update(
                    tuple(tuple(e) if isinstance(e, list) else e for e in s) for s in v)
            for case in rank["cases"]:
                key = "fused_bottleneck" + ("_bf16" if case["dtype"] == "bfloat16" else "")
                launches[key].append(case["forward"]["eval_launches"])
            for case in rank["train"]:
                counts, leg = case["launches"], case["leg"]
                if leg in ("float32", "bfloat16"):
                    for key in ("fused_iw_max_square_loss", "fused_iw_max_square_loss_backward",
                                "fused_bottleneck_emit" + ("_bf16" if leg == "bfloat16" else "")):
                        launches[key].append(counts[key])
                elif leg == "concat_float32":
                    launches["fused_bottleneck_emit_masked"].append(
                        counts["fused_bottleneck_emit_masked"])
                else:
                    launches["fused_bottleneck_emit_remat"].append(counts["fused_bottleneck_emit"])
            if rank["export"] is not None:
                launches["fused_bottleneck_bf16_export"].append(rank["export"]["eval_launches"])
        emit({"phase": "sp_train", "sp": sp, "world": nproc, "backend": backend,
              "limits": SP_TRAIN_LIMITS, "vs_one_process": parity,
              "trainer_vs_one_process": trainer,
              "step_ms_one_process": {leg: r["step_ms"] for leg, r in refs.items()},
              "peak_memory_gib_one_process": {leg: r["peak_memory_gib"]
                                              for leg, r in refs.items()},
              "step_ms_per_rank": {c["leg"]: [r["train"][i]["step_ms"] for r in ranks]
                                   for i, c in enumerate(ranks[0]["train"])},
              "peak_memory_gib_per_rank": {c["leg"]: [r["train"][i]["peak_memory_gib"]
                                                      for r in ranks]
                                           for i, c in enumerate(ranks[0]["train"])},
              "halo_per_rank": {c["leg"]: [r["train"][i]["halo"] for r in ranks]
                                for i, c in enumerate(ranks[0]["train"])}})
        emit({"phase": "sp_shapes", "sp": sp, "world": nproc,
              "launch_shapes": {k: sorted(v) for k, v in seen.items()}})
        for kernel in seen:  # a bf16 shape is held in both instances
            checked.setdefault(kernel, set())
        for kernel in ("fused_bottleneck_bf16", "fused_bottleneck_emit_bf16"):
            checked.setdefault(kernel, set())
        hold_path_shapes("sp", seen, checked)
    shutil.rmtree(export_root, ignore_errors=True)
    return launches


def _ddp_worker(argv: list[str]) -> int:
    """A rank started by ``torchrun`` (``chip_smoke.py --ddp-worker KIND OUT
    ...``); rank 0 writes its results under OUT.
    parity BACKEND DEVICE: the parity steps on this rank's share of the
        global batch (DEVICE ``cuda:0`` puts every rank on one card, ``-``
        gives each its ``LOCAL_RANK`` card), then 2 + REPS DDP steps of 4 +
        4 images a rank, timed;
    trainer: the bare step (2 + REPS) and a UDATrainer over in-memory
        loaders (TRAINER_ITERS iterations, 4 + 4 images a rank, a
        validation), with NCCL;
    cli MODULE ARGS...: MODULE's ``main(ARGS)``, counted;
    sp BACKEND DEVICE SP: the sp phase's rank (``_sp_worker``)."""
    import warnings

    from maxsquareloss_torch.parallel import ddp

    kind, out = argv[0], argv[1]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"kind": kind}
    if kind == "sp":
        _sp_worker(out, argv[2], argv[3], int(argv[4]))
        ddp.shutdown()
        return 0
    if kind == "cli":
        module = importlib.import_module(argv[2])
        zero_counts()
        module.main(argv[3:])
        torch.cuda.synchronize()
        result.update(launch_counts=read_counts())
    elif kind == "parity":
        backend, device = argv[2], argv[3]
        ddp.init_distributed(backend)
        dev = resolve_device(None if device == "-" else device)
        model = init_deeplabv2(model_config(TRAIN_CFG), torch.Generator().manual_seed(0),
                               device=dev)
        per = ddp.local_batch(TRAIN_BATCH)
        rows = slice(ddp.rank() * per, (ddp.rank() + 1) * per)
        zero_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            steps, valid, state = _ddp_steps(model, _ddp_pairs(dev), rows)
            torch.cuda.synchronize()
        counts = read_counts()
        strides = [str(w.message) for w in caught if "stride" in str(w.message).lower()]
        check(not strides, f"DDP: {strides[:1]}")
        result.update(world=ddp.world(), backend=backend, device=str(dev),
                      launch_counts_parity_steps=counts, valid_pixels=valid)
        if backend == "nccl":
            # the step rate over the cards, 4 + 4 images a rank (the same
            # DDP wrapper: one per model)
            pairs = [tuple(t.to(dev) for t in p) for p in _train_pairs()]
            step_s = _median_step_s(make_uda_train_step(TRAIN_CFG), state, pairs)
            result.update(step_s=step_s, images_per_s=2 * TRAIN_BATCH * ddp.world() / step_s)
        ranks = ddp.all_gather(torch.tensor([*valid["source"], *valid["target_label"],
                                             counts["fused_bottleneck_emit"]], device=dev))
        # per rank: source valid pixels of each step, target label pixels of
        # each step, emit launches
        result["per_rank_valid_and_emit"] = ranks.tolist()
        if ddp.is_main():
            torch.save(steps, os.path.join(out, "steps.pt"))
    elif kind == "trainer":
        from maxsquareloss_torch.parallel import multihost

        multihost.initialize_distributed()
        dev = resolve_device(None)
        model = init_deeplabv2(model_config(TRAIN_CFG), torch.Generator().manual_seed(0),
                               device=dev)
        pairs = [tuple(t.to(dev) for t in p) for p in _train_pairs()]
        bare = 1.0 / _median_step_s(make_uda_train_step(TRAIN_CFG),
                                    make_train_state(model, TRAIN_CFG), pairs)
        del model, pairs
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(
            TRAIN_CFG, iter_stop=TRAINER_ITERS, num_workers=8, tqdm=False, show_num_images=0,
            batch_size=TRAIN_BATCH * ddp.world(), eval_batch_size=VAL_BATCH * ddp.world(),
            checkpoint_dir=os.path.join(out, "trainer"))
        model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device=dev)
        trainer = UDATrainer(cfg, *_trainer_loaders(cfg), model=model)
        zero_counts()
        trainer.train()
        torch.cuda.synchronize()
        counts = read_counts()
        result.update(world=ddp.world(), ddp_wrapper=trainer.state.ddp_loss is not None,
                      bare_steps_per_s=bare, launch_counts=counts)
        if ddp.is_main():
            losses = _scalars(cfg.checkpoint_dir)["train/loss"]
            check(sorted(losses) == list(range(1, TRAINER_ITERS + 1)), f"loss steps {sorted(losses)}")
            check(all(math.isfinite(r["value"]) for r in losses.values()), "non-finite loss")
            ts = [losses[i]["ts"] for i in range(TRAINER_SAVE_ITER - 1, TRAINER_ITERS + 1)]
            rate = statistics.median(1.0 / (b - a) for a, b in zip(ts, ts[1:]))
            result.update(trainer_steps_per_s=rate, gap_vs_bare_step=1.0 - rate / bare,
                          val_MIoU=_scalars(cfg.checkpoint_dir)["val/MIoU"][TRAINER_ITERS]["value"])
    else:
        raise ValueError(f"unknown ddp worker {kind!r}")
    if ddp.is_main():
        with open(os.path.join(out, f"{kind}.json"), "w") as f:
            json.dump(result, f)
    ddp.shutdown()
    return 0


def _torchrun(nproc: int, target: list[str], what: str) -> str:
    """``torchrun --standalone --nproc_per_node nproc`` of ``target`` in the
    repo root, TF32 off; fails the run on a non-zero exit or a timeout (and
    kills every process it started). Returns its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "NVIDIA_TF32_OVERRIDE": "0", "OMP_NUM_THREADS": "4",
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *target]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=DDP_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise RuntimeError(f"chip_smoke check failed: {what} ran past {DDP_TIMEOUT_S} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    if proc.returncode != 0:
        print(out[-8000:], file=sys.stderr, flush=True)
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}")
    emit({"phase": "ddp_launch", "what": what, "nproc": nproc,
          "seconds": time.perf_counter() - t0})
    return out


def _ddp_parity(p0: dict, ref: list, got: list) -> list:
    """Each step's metric errors (relative) and each parameter's change
    (relative L2) against the one-process steps on the global batch, both
    from ``p0``."""
    report = []
    for (m_r, p_r), (m_g, p_g) in zip(ref, got):
        err = {k: abs(m_g[k] - m_r[k]) / max(abs(m_r[k]), 1e-30) if k in m_g else math.inf
               for k in m_r}
        param_err = {n: _rel_l2(p_g[n] - p0[n], p_r[n] - p0[n]) for n in p_r}
        worst = max(param_err, key=param_err.get)
        report.append({"metric_rel_err": err, "param_change_rel_l2_max": param_err[worst],
                       "param_change_rel_l2_worst": worst,
                       "param_change_rel_l2_median": statistics.median(param_err.values()),
                       "finite": all(math.isfinite(v) for v in m_g.values())})
    return report


def _check_ddp_parity(name: str, report: list) -> None:
    """The train phase's limits: every metric rel STEP_RTOL, each
    parameter's change relative L2 STEP_PARAM_RTOL_L2."""
    for i, r in enumerate(report):
        bad = {k: v for k, v in r["metric_rel_err"].items() if not v <= STEP_RTOL}
        check(r["finite"] and not bad, f"{name} step {i}: metrics off {bad}")
        check(r["param_change_rel_l2_max"] <= STEP_PARAM_RTOL_L2,
              f"{name} step {i}: {r['param_change_rel_l2_worst']} change off by "
              f"{r['param_change_rel_l2_max']:.3g} (relative L2)")


def _ddp_reference(per_rank: set, checked: dict):
    """The emit and IW loss kernels held against their plain versions at the
    shapes of ranks with ``per_rank`` images that no phase checked; then the
    one-process parity steps on the global batches. Returns (the starting
    parameters, the steps, their valid pixel counts, the launch counts, the
    train state)."""
    seen = {k: set() for k in checked}
    for n in per_rank:
        seen["fused_bottleneck_emit"] |= {s[1:7] for s in block_shapes(n, SRC_HW)
                                          + block_shapes(n, TGT_HW)}
        seen["fused_iw_max_square_loss"].add((n, *TGT_HW, NUM_CLASSES))
    hold_path_shapes("ddp", seen, checked)
    torch.cuda.synchronize()
    model = init_deeplabv2(model_config(TRAIN_CFG), torch.Generator().manual_seed(0),
                           device="cuda")
    p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    zero_counts()
    ref, ref_valid, state = _ddp_steps(model, _ddp_pairs("cuda"), slice(None))
    return p0, ref, ref_valid, read_counts(), state


def _ddp_several_cards(cards: int, p0: dict, ref: list, one_card_images_per_s: float,
                       work: str) -> None:
    """Case (c): the parity steps over ``cards`` NCCL ranks, one card each,
    against the one-process steps, and the step rate at 4 + 4 images a card
    beside one card's."""
    _torchrun(cards, [os.path.abspath(__file__), "--ddp-worker", "parity", work, "nccl", "-"],
              f"parity, {cards} NCCL ranks")
    with open(os.path.join(work, "parity.json")) as f:
        multi = json.load(f)
    steps = torch.load(os.path.join(work, "steps.pt"))
    report = _ddp_parity(p0, ref, steps)
    emit({"phase": "ddp_parity", "case": "c_several_cards", "ran": True,
          "world": multi["world"], "backend": "nccl", "vs_one_process": report,
          "metrics": [m for m, _ in steps], "metrics_one_process": [m for m, _ in ref],
          "launch_counts_per_rank": multi["launch_counts_parity_steps"],
          "images_per_s": multi["images_per_s"], "step_s": multi["step_s"],
          "images_per_s_one_card": one_card_images_per_s,
          "scaling_efficiency": multi["images_per_s"] / (cards * one_card_images_per_s),
          "per_rank_source_valid_target_label_valid_emit_launches":
              multi["per_rank_valid_and_emit"]})
    check(multi["world"] == cards, f"world {multi['world']}, not {cards}")
    check(all(r[4] == 2 * 58 for r in multi["per_rank_valid_and_emit"]),
          f"emit launches per rank {multi['per_rank_valid_and_emit']}")
    _check_ddp_parity("ddp over cards", report)


def _ddp_torchrun_runs(cards: int, work: str, full: bool) -> None:
    """Case (b): ``torchrun --nproc_per_node cards`` with NCCL for
    ``solve_gta5`` (2 iterations, validation, checkpoint); with ``full``
    (``--ddp-cards``) also its ``--continue_training`` resume to iteration
    4, ``evaluate`` (the one-process mIoU within 1e-4), and the UDATrainer
    within DDP_TRAINER_GAP of the bare step of the same world."""
    from maxsquareloss_torch.data.synthetic import write_domain_shift_pair

    me = os.path.abspath(__file__)
    data = os.path.join(work, "data")
    write_domain_shift_pair(data, n_source=8 * cards, n_target_train=8 * cards,
                            n_target_val=4 * cards, hw=(128, 256))
    run = os.path.join(work, "run")
    cli = ["--data_root_path", data, "--checkpoint_dir", run, *CLI_SIZE,
           "--target_base_size", "256,128", "--target_crop_size", "256,128",
           "--batch_size", str(2 * cards), "--num_workers", "4", "--tqdm", "false",
           "--iw_hist", "argmax"]
    _torchrun(cards, [me, "--ddp-worker", "cli", work, "maxsquareloss_torch.tools.solve_gta5",
                      *cli, "--iter_stop", "2"], "torchrun solve_gta5")
    with open(os.path.join(work, "cli.json")) as f:
        cli_counts = json.load(f)["launch_counts"]
    val_batches = 2  # 4 images a card, 2 a batch
    check(cli_counts["fused_bottleneck_emit"] == 2 * 58
          and cli_counts["fused_bottleneck"] == 29 * val_batches,
          f"torchrun solve_gta5 launches on rank 0: {cli_counts}")
    first = ckpt_lib.load_checkpoint(os.path.join(run, ckpt_lib.LATEST))
    check(first["iteration"] == 2, f"checkpoint at iteration {first['iteration']}")
    check(not any(k.startswith("module.") for k in first["state_dict"]), "module. prefix")
    if not full:
        emit({"phase": "ddp_cli", "nproc": cards, "backend": "nccl",
              "solve_gta5_launch_counts_rank0": cli_counts,
              "moved_to_ddp_cards": ["solve_gta5 --continue_training", "evaluate",
                                     "UDATrainer"]})
        return
    _torchrun(cards, ["-m", "maxsquareloss_torch.tools.solve_gta5", *cli, "--iter_stop", "4",
                      "--continue_training"], "torchrun solve_gta5 --continue_training")
    scal = _scalars(run)
    check(sorted(scal["train/loss"]) == [1, 2, 3, 4]
          and all(math.isfinite(r["value"]) for r in scal["train/loss"].values()),
          f"resumed losses {scal['train/loss']}")
    check(ckpt_lib.load_checkpoint(os.path.join(run, ckpt_lib.LATEST))["iteration"] == 4,
          "the resume did not reach iteration 4")
    served = ["--dataset", "cityscapes", "--data_root_path", data,
              "--pretrained_ckpt_file", os.path.join(run, ckpt_lib.LATEST), *CLI_SIZE,
              "--batch_size", str(2 * cards), "--num_workers", "4",
              "--checkpoint_dir", os.path.join(work, "ev")]
    out = _torchrun(cards, ["-m", "maxsquareloss_torch.tools.evaluate", *served],
                    "torchrun evaluate")
    from maxsquareloss_torch.tools import evaluate as evaluate_cli

    printed = [ln for ln in out.splitlines() if ln.startswith("{'PA'")]
    check(len(printed) == 1, f"torchrun evaluate printed {len(printed)} metric lines")
    got = {k: float(v) for k, v in re.findall(r"'(\w+)': (?:np\.float64\()?([-0-9.eE+]+)",
                                               printed[0])}
    want = evaluate_cli.main([*served, "--checkpoint_dir", os.path.join(work, "ev1")])
    check(abs(got["MIoU"] - want["MIoU"]) <= 1e-4,
          f"torchrun evaluate mIoU {got['MIoU']} vs one process {want['MIoU']}")
    emit({"phase": "ddp_cli", "nproc": cards, "backend": "nccl",
          "solve_gta5_launch_counts_rank0": cli_counts,
          "losses": {i: r["value"] for i, r in scal["train/loss"].items()},
          "val_MIoU": {i: r["value"] for i, r in scal["val/MIoU"].items()},
          "evaluate": got, "evaluate_one_process": want})
    _torchrun(cards, [me, "--ddp-worker", "trainer", work], "torchrun UDATrainer")
    with open(os.path.join(work, "trainer.json")) as f:
        tr = json.load(f)
    # at world 1 (one card) this is the one-process trainer under
    # torchrun against the bare step: no DDP wrapper, no collective
    check(tr["gap_vs_bare_step"] <= DDP_TRAINER_GAP,
          f"the torchrun trainer at world {tr['world']} is {tr['gap_vs_bare_step']:.3f} "
          "under the bare step")
    check(tr["launch_counts"]["fused_bottleneck_emit"] == 58 * TRAINER_ITERS
          and tr["launch_counts"]["fused_bottleneck"] == 29 * 2,
          f"DDP trainer launches on rank 0 {tr['launch_counts']}")
    emit({"phase": "ddp_trainer", "nproc": cards, "backend": "nccl",
          "gate": f"the world-{tr['world']} trainer against the bare step", **tr})


def phase_ddp(bare_steps_per_s: float, checked: dict) -> None:
    """Data parallelism on the card: (a) two gloo ranks on the one card
    against the one-process step on the same global batch; (b) torchrun
    with NCCL over every card: ``solve_gta5`` (2 iterations, validation,
    checkpoint), its --continue_training resume, ``evaluate``, and the
    UDATrainer against the bare step (with one card: world 1, so no DDP
    wrapper and no collective); (c) with several cards, the parity steps
    and the step rate over them. First the kernels are held against their
    plain versions at the ranks' shapes that no phase checked."""
    cards = torch.cuda.device_count()
    per_rank = {TRAIN_BATCH // DDP_SHARED_RANKS}
    if cards > 1 and TRAIN_BATCH % cards == 0:
        per_rank.add(TRAIN_BATCH // cards)
    p0, ref, ref_valid, one_counts, state = _ddp_reference(per_rank, checked)
    del state
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    me = os.path.abspath(__file__)
    try:
        # (a) two ranks on the one card, gloo
        _torchrun(DDP_SHARED_RANKS, [me, "--ddp-worker", "parity", work, "gloo", "cuda:0"],
                  "parity, 2 gloo ranks on one card")
        with open(os.path.join(work, "parity.json")) as f:
            shared = json.load(f)
        steps = torch.load(os.path.join(work, "steps.pt"))
        per_rank = shared["per_rank_valid_and_emit"]
        report = _ddp_parity(p0, ref, steps)
        emit({"phase": "ddp_parity", "case": "a_shared_card", "world": shared["world"],
              "backend": "gloo", "steps": ["IW_maxsquare", "hard"], "vs_one_process": report,
              "metrics": [m for m, _ in steps], "metrics_one_process": [m for m, _ in ref],
              "valid_pixels_one_process": ref_valid,
              "per_rank_source_valid_target_label_valid_emit_launches": per_rank,
              "launch_counts_per_rank": shared["launch_counts_parity_steps"],
              "launch_counts_one_process": one_counts})
        check(len({r[1] for r in per_rank}) > 1, f"the ranks' source counts are equal: {per_rank}")
        check(all(r[4] == 2 * 58 for r in per_rank), f"emit launches per rank {per_rank}")
        _check_ddp_parity("ddp shared card", report)
        del steps

        # (b) torchrun with NCCL over every card: solve_gta5 (the resume,
        # evaluate and the trainer run in --ddp-cards, over several cards)
        _ddp_torchrun_runs(cards, work, full=False)

        # (c) several cards
        if cards < 2:
            emit({"phase": "ddp_parity", "case": "c_several_cards", "ran": False,
                  "why": f"this machine has {cards} card: NCCL over cards needs 2 or more"})
        elif TRAIN_BATCH % cards:
            emit({"phase": "ddp_parity", "case": "c_several_cards", "ran": False,
                  "why": f"{cards} cards do not share a global batch of {TRAIN_BATCH}"})
        else:
            _ddp_several_cards(cards, p0, ref, bare_steps_per_s * 2 * TRAIN_BATCH, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _sp_cli_run(cards: int, work: str) -> None:
    """``torchrun --nproc_per_node cards`` of ``solve_gta5 --sp 2`` (dp
    cards/2 x sp 2, NCCL): 2 iterations, a validation and a checkpoint on a
    small on-disk pair, against ``solve_gta5`` in this process on the same
    data from the same ``.pth``: losses rel SP_TRAINER_RTOL, the validation
    mIoU within SP_MIOU_TOL, parameter changes STEP_PARAM_RTOL_L2 (the
    metrics over the thresholded pseudo-label set and the IW weights'
    maximum within SP_CLI_THRESHOLDED_RTOL); rank 0's launches exact."""
    from maxsquareloss_torch.convert import reference_state_dict
    from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
    from maxsquareloss_torch.tools import solve_gta5

    groups = cards // 2
    data = os.path.join(work, "sp_data")
    write_domain_shift_pair(data, n_source=4 * groups, n_target_train=4 * groups,
                            n_target_val=2 * groups, hw=(128, 256))
    start = init_deeplabv2(model_config(TRAIN_CFG), torch.Generator().manual_seed(0),
                           device="cpu")
    init = os.path.join(work, "sp_init.pth")
    torch.save({"state_dict": reference_state_dict(start)}, init)
    cli = ["--data_root_path", data, *CLI_SIZE, "--target_base_size", "256,128",
           "--target_crop_size", "256,128", "--batch_size", str(2 * groups), "--num_workers",
           "4", "--tqdm", "false", "--iw_hist", "argmax", "--iter_stop", "2",
           "--pretrained_ckpt_file", init]
    run = os.path.join(work, "sp_run")
    _torchrun(cards, [os.path.abspath(__file__), "--ddp-worker", "cli", work,
                      "maxsquareloss_torch.tools.solve_gta5", *cli, "--sp", "2",
                      "--checkpoint_dir", run], f"torchrun solve_gta5 --sp 2 over {cards} cards")
    with open(os.path.join(work, "cli.json")) as f:
        counts = json.load(f)["launch_counts"]
    check(counts["fused_bottleneck_emit"] == 2 * 58 and counts["fused_bottleneck"] == 29
          and counts["fused_iw_max_square_loss"] == 2,
          f"torchrun solve_gta5 --sp 2 launches on rank 0: {counts}")
    one = solve_gta5.main([*cli, "--checkpoint_dir", os.path.join(work, "sp_one")])
    got, want = _scalars(run), _scalars(os.path.join(work, "sp_one"))
    check(sorted(got["train/loss"]) == sorted(want["train/loss"]) == [1, 2],
          f"solve_gta5 --sp 2 loss steps {sorted(got['train/loss'])}")
    rel = {tag: max(abs(got[tag][i]["value"] - r["value"]) / max(abs(r["value"]), 1e-30)
                    for i, r in want[tag].items())
           for tag in want if tag.startswith("train/") and tag != "train/images_per_sec"}
    miou = (got["val/MIoU"][2]["value"], want["val/MIoU"][2]["value"])
    allowed = {t: SP_CLI_THRESHOLDED_RTOL if t[len("train/"):] in BF16_THRESHOLDED
               else SP_TRAINER_RTOL for t in rel}
    check(all(rel[t] <= allowed[t] for t in rel), f"solve_gta5 --sp 2 scalars off by {rel}")
    check(abs(miou[0] - miou[1]) <= SP_MIOU_TOL, f"solve_gta5 --sp 2 mIoU {miou}")
    blob = ckpt_lib.load_checkpoint(os.path.join(run, ckpt_lib.LATEST))
    check(blob["iteration"] == 2, f"solve_gta5 --sp 2 checkpoint at {blob['iteration']}")
    p0 = {n: p.detach() for n, p in start.named_parameters()}
    ref = {n: p.detach().cpu().clone() for n, p in one.model.named_parameters()}
    ckpt_lib.load_weights(one.model, blob, TRAIN_CFG.num_classes)
    report = _ddp_parity(p0, [({}, ref)], [({}, {n: p.detach().cpu() for n, p
                                                   in one.model.named_parameters()})])[0]
    check(report["param_change_rel_l2_max"] <= STEP_PARAM_RTOL_L2,
          f"solve_gta5 --sp 2: {report['param_change_rel_l2_worst']} change off by "
          f"{report['param_change_rel_l2_max']:.3g}")
    emit({"phase": "sp_cli", "nproc": cards, "sp": 2, "backend": "nccl",
          "launch_counts_rank0": counts, "scalar_rel_err_max": rel, "val_MIoU": miou[0],
          "val_MIoU_one_process": miou[1],
          "param_change_rel_l2_max": report["param_change_rel_l2_max"],
          "param_change_rel_l2_worst": report["param_change_rel_l2_worst"]})
    del one
    torch.cuda.empty_cache()


def main_ddp_cards() -> int:
    """``--ddp-cards``: the ddp phase over several cards alone, for a
    machine with several: the build, the kernels at the ranks' shapes, the
    one-process parity steps and one card's step rate, then (c) and (b)
    over every card, then the sp phase with NCCL over them (its training
    legs too), then ``solve_gta5 --sp 2`` over them."""
    cards = torch.cuda.device_count()
    check(cards >= 2 and TRAIN_BATCH % cards == 0,
          f"--ddp-cards needs 2 or more cards that share a global batch of {TRAIN_BATCH}; "
          f"this machine has {cards}")
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    checked = {"fused_bottleneck_emit": set(), "fused_iw_max_square_loss": set()}
    p0, ref, _, _, state = _ddp_reference({TRAIN_BATCH // cards}, checked)
    pairs = [tuple(t.to("cuda") for t in p) for p in _train_pairs()]
    step_s = _median_step_s(make_uda_train_step(TRAIN_CFG), state, pairs)
    emit({"phase": "ddp_one_card", "step_s": step_s, "steps_per_s": 1.0 / step_s,
          "images_per_s": 2 * TRAIN_BATCH / step_s})
    del state, pairs
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    try:
        _ddp_several_cards(cards, p0, ref, 2 * TRAIN_BATCH / step_s, work)
        _ddp_torchrun_runs(cards, work, full=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t_sp = time.perf_counter()
    launches = phase_sp({}, cards)
    check(all(n > 0 for per_rank in launches.values() for n in per_rank),
          f"a rank launched no kernel of the sp path: {launches}")
    work = tempfile.mkdtemp(prefix="chip_smoke_sp_cli_")
    try:
        _sp_cli_run(cards, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "summary", "wall_seconds": time.perf_counter() - t_start,
          "seconds_by_phase": {"sp": time.perf_counter() - t_sp}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": cards}})
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ddp-worker"]:
        return _ddp_worker(sys.argv[2:])
    if sys.argv[1:] == ["--ddp-cards"]:
        return main_ddp_cards()
    t_start = time.perf_counter()
    seconds = {}

    def lap(name):  # the seconds since the last lap, by phase
        seconds[name] = time.perf_counter() - t_start - sum(seconds.values())

    phase_environment()
    phase_build()
    lap("build")
    phase_hostops()
    lap("hostops")
    checked, kernel = phase_kernels()
    kernel["launches"] = phase_slice(checked)["launches"]
    lap("kernels_slice")
    train_kernels = phase_train_loss_kernels()
    emit_checked, emit_kernel = phase_train_block()
    train_kernels.insert(0, emit_kernel)
    counts, bare_steps_per_s = phase_train(emit_checked)
    for k in train_kernels:
        k["launches"] = counts[k["name"]]
    lap("train")
    probe = phase_probe()
    probe["launches"] = phase_probe_main()
    lap("probe")
    phase_trainer(bare_steps_per_s)
    lap("trainer")
    masked_checked, masked_kernel = phase_concat_kernels()
    masked_kernel["launches"] = phase_concat(emit_checked, masked_checked)[
        "fused_bottleneck_emit_masked"]
    lap("concat")
    bf16_checked, bf16_kernels = phase_bf16_kernels()
    bf16_step_counts, bf16_eval_counts = phase_bf16(bf16_checked)
    bf16_kernels[0]["launches"] = bf16_eval_counts["fused_bottleneck_bf16"]
    bf16_kernels[1]["launches"] = bf16_step_counts["fused_bottleneck_emit_bf16"]
    # the launches whose plan put conv2 on wgmma: all of them (the exact
    # launch checks hold the *_conv2_fma counts at 0)
    bf16_kernels[0]["conv2_tc_launches"] = (bf16_eval_counts["fused_bottleneck_bf16"]
                                            - bf16_eval_counts["fused_bottleneck_bf16_conv2_fma"])
    bf16_kernels[1]["conv2_tc_launches"] = (
        bf16_step_counts["fused_bottleneck_emit_bf16"]
        - bf16_step_counts["fused_bottleneck_emit_bf16_conv2_fma"])
    lap("bf16")
    phase_remat()
    lap("remat")
    # the later paths: every launch shape no phase above checked is held
    # against the plain version after the path's run
    loss_checked = {(*shape, NUM_CLASSES) for shape in LOSS_SHAPES}
    checked_all = {"fused_bottleneck": checked, "fused_bottleneck_emit": emit_checked,
                   **bf16_checked, **{name: set(loss_checked) for name in LOSSES}}
    for path, phase in (("int8", phase_int8), ("export", phase_export)):
        with recorded_shapes() as seen:
            phase()
        hold_path_shapes(path, seen, checked_all)
        lap(path)
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
    lap("cli")
    for path, phase in (("crosscity", phase_crosscity), ("bench", phase_bench),
                        ("efficacy", phase_efficacy)):
        with recorded_shapes() as seen:
            phase()
        hold_path_shapes(path, seen, checked_all)
        lap(path)
    sp_launches = phase_sp(checked_all)
    kernel["sp_launches_per_rank"] = sp_launches["fused_bottleneck"]
    bf16_kernels[0]["sp_launches_per_rank"] = sp_launches["fused_bottleneck_bf16"]
    # the sharded bf16 artifact: each rank's launches in one forward
    bf16_kernels[0]["sp_export_launches_per_rank"] = sp_launches["fused_bottleneck_bf16_export"]
    # the training path under --sp: each rank's launches in one UDA step
    for k in (*train_kernels, bf16_kernels[1]):
        if k["name"] in sp_launches:
            k["sp_train_launches_per_rank_per_step"] = sp_launches[k["name"]]
    train_kernels[0]["sp_remat_launches_per_rank_per_step"] = sp_launches[
        "fused_bottleneck_emit_remat"]
    masked_kernel["sp_train_launches_per_rank_per_step"] = sp_launches[
        "fused_bottleneck_emit_masked"]
    lap("sp")
    phase_ddp(bare_steps_per_s, checked_all)
    lap("ddp")
    kernels = (kernel, *train_kernels, masked_kernel, *bf16_kernels, probe)
    for k in kernels:
        check(k["launches"] > 0, f"the main path launched no {k['name']}")
        check(all(n > 0 for key in ("sp_launches_per_rank", "sp_export_launches_per_rank",
                                    "sp_train_launches_per_rank_per_step",
                                    "sp_remat_launches_per_rank_per_step")
                  for n in k.get(key, [1])),
              f"a rank of the sp path launched no {k['name']}")
    emit({"phase": "summary", "wall_seconds": time.perf_counter() - t_start,
          "seconds_by_phase": seconds})
    emit({"kernels": [{key: v for key, v in k.items() if key not in ("shapes", "checks")}
                      for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
