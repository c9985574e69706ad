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
     (the larger of FLOPs over 67 TFLOP/s fp32 and bytes over 3.35 TB/s);
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
     (4, 512, 1024, 19) and a ragged (1, 37, 53, 19), with exact ties
     between two classes and a degenerate class weight of 1.0 (forward rel
     1e-4, grads atol 1e-5 and 1e-4 of the largest), each bitwise equal on
     a second call; the emit bottleneck's out, h1, h2 at the 8 training
     shapes (rtol = atol = 1e-4) and its autograd backward against the
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
  8. train profile: device time by kernel name over one train step.
Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, when CUDA is absent or a check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.data.synthetic import SyntheticSegDataset, uint8_batches
from maxsquareloss_torch.kernels import build as kernel_build
from maxsquareloss_torch.kernels import fused_block, fused_loss
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
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2, init_deeplabv2, valid_logits_hw
from maxsquareloss_torch.ops.histogram import class_histogram, iw_class_weights
from maxsquareloss_torch.predict import make_predict_fn
from maxsquareloss_torch.train import steps as train_steps
from maxsquareloss_torch.train.evaluator import evaluate
from maxsquareloss_torch.train.steps import (
    _prepare_inputs,
    make_train_state,
    make_uda_train_step,
    model_config,
)

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
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
LOSS_SHAPES = ((TRAIN_BATCH, *TGT_HW), (1, 37, 53))  # the main path's, a ragged one
NUM_CLASSES = TRAIN_CFG.num_classes
WARMUP_STEPS = 2
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL_MAX = 1e-4, 1e-5, 1e-4
# the block backward, relative L2 per tensor: the adjoint chain on the
# plain forward's saved tensors 1e-4; the whole kernel path 1e-3, since a
# pre-activation within fp32 rounding of 0 takes the other ReLU mask in the
# kernel's forward than in cuDNN's and passes a whole gradient element
BACKWARD_RTOL_L2, BACKWARD_E2E_RTOL_L2 = 1e-4, 1e-3
STEP_RTOL, STEP_PARAM_RTOL_L2 = 1e-4, 1e-3

# the launch count of every kernel, by the name it has in the kernels line
COUNTERS = {
    "fused_bottleneck": (fused_bottleneck, "launches"),
    "fused_bottleneck_emit": (fused_bottleneck_emit, "launches"),
    "fused_iw_max_square_loss": (fused_iw_max_square_loss, "launches"),
    "fused_iw_max_square_loss_backward": (fused_iw_max_square_loss, "backward_launches"),
    "fused_max_square_loss": (fused_max_square_loss, "launches"),
    "fused_max_square_loss_backward": (fused_max_square_loss, "backward_launches"),
}


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
    sources = (fused_block.SOURCE, fused_loss.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(kernel_build.build, sources))
    fused_block._library()
    fused_loss._library()
    emit({"phase": "build", "libraries": [lib.name for lib in libs],
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
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    return args, {
        "layer": name, "shape": [n, h, w, cin], "cmid": cmid, "dilation": d,
        "tile": list(fused_block.plan_tiles(n, h, w, cmid, d, sm_count)),
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
    # device-side events only: a CPU op's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top_n]
    emit({"phase": "profile", "run": run, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / (wall * 1e3),
          "top": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                   "calls": e.count} for e in top]})


def _worst(got, want) -> tuple[float, float]:
    """(max abs error, worst error over the rtol = atol = 1e-4 tolerance)."""
    err = (got - want).abs()
    return err.max().item(), (err / (ATOL + RTOL * want.abs())).max().item()


def _rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _loss_inputs(gen, n, h, w):
    """Logits with exact ties between classes 3 and 11 at the max on every
    7th pixel, and IW weights from a guidance label that ignores class 5,
    so class 5 takes the degenerate weight 1.0 where it is the argmax."""
    logits = torch.randn(n, h, w, NUM_CLASSES, generator=gen) * 3.0
    tied = logits.view(-1, NUM_CLASSES)[::7]
    top = tied.amax(dim=-1) + 1.0
    tied[:, 3] = top
    tied[:, 11] = top
    logits = logits.cuda()
    amax = logits.argmax(dim=-1)
    weights = iw_class_weights(class_histogram(torch.where(amax == 5, -1, amax), NUM_CLASSES))
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
    """Both loss kernels at the main path's shape and a ragged one; timed at
    the main path's. Returns four kernels-line entries."""
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

        def k_fwd():
            return fn(logits, *rest)

        def k_bwd():
            return fused_loss._launch_backward(logits, weights, g, coef)

        def p_fwd():
            with torch.no_grad():
                return plain(logits, *rest)

        def p_both():
            return torch.autograd.grad(plain(x, *rest), x, g)

        reps = 10
        pf1, kf1, kf2, pf2 = (time_ms(f, reps) for f in (p_fwd, k_fwd, k_fwd, p_fwd))
        pb1, kb1, kb2, pb2 = (time_ms(f, reps) for f in (p_both, k_bwd, k_bwd, p_both))
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
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
                "library": "none: no single PyTorch call computes this loss",
                "shape": list(logits.shape), "checks": rows,
            })
            emit({"phase": "kernel", **{k: v for k, v in entries[-1].items() if k != "checks"}})
        del logits, weights, x
    torch.cuda.empty_cache()
    return entries


def phase_train_block() -> tuple[set, dict]:
    """The emit bottleneck at every training shape (out, h1, h2), timed;
    its autograd backward at one shape per layer. Returns the checked
    shapes and the kernels-line entry (times per train step)."""
    gen = torch.Generator().manual_seed(2)
    checked, rows = set(), []
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n, h, w, cin, cmid, d, per_fwd in TRAIN_SHAPES:
        args = _block_inputs(gen, n, h, w, cin, cmid)
        got = fused_bottleneck_emit(*args, d)
        want = fused_bottleneck_emit_reference(*args, d)
        torch.cuda.synchronize()
        row = {"layer": name, "shape": [n, h, w, cin], "cmid": cmid, "dilation": d,
               "tile": list(fused_block.plan_tiles(n, h, w, cmid, d, sm_count))}
        for label, a, b in zip(("out", "h1", "h2"), got, want):
            check(bool(torch.isfinite(a).all()), f"emit {name}: non-finite {label}")
            max_abs, worst = _worst(a, b)
            check(worst <= 1.0, f"emit {name} {label}: {max_abs:.3g} abs, {worst:.3g}x the tolerance")
            row[f"{label}_max_abs_err"], row[f"{label}_worst_over_tol"] = max_abs, worst
        checked.add((n, h, w, cin, cmid, d))
        del got, want

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


def phase_train(emit_checked: set) -> dict[str, int]:
    """The UDA step: parity of one kernel-path and one plain-path step, then
    the counted, timed main path. Returns the main path's launch counts."""
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
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a GPU",
              file=sys.stderr)
        return 1
    phase_environment()
    phase_build()
    checked, kernel = phase_kernels()
    kernel["launches"] = phase_slice(checked)["launches"]
    train_kernels = phase_train_loss_kernels()
    emit_checked, emit_kernel = phase_train_block()
    train_kernels.insert(0, emit_kernel)
    counts = phase_train(emit_checked)
    for k in train_kernels:
        k["launches"] = counts[k["name"]]
    for k in (kernel, *train_kernels):
        check(k["launches"] > 0, f"the main path launched no {k['name']}")
    emit({"kernels": [{key: v for key, v in k.items() if key not in ("shapes", "checks")}
                      for k in (kernel, *train_kernels)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
