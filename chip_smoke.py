#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:
  1. environment: the card (as nvidia-smi reports name and power limit),
     torch and CUDA versions; TF32 is switched off for cuDNN and matmul so
     every plain fp32 reference runs in full fp32;
  2. build: compiles every kernel of the port from ``maxsquareloss_torch/csrc``;
  3. kernels: each kernel against its plain PyTorch version at every shape
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
     and the device's idle share.
Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, when CUDA is absent or a check fails.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.data.synthetic import SyntheticSegDataset, uint8_batches
from maxsquareloss_torch.kernels import fused_block
from maxsquareloss_torch.kernels.fused_block import (
    fused_bottleneck,
    fused_bottleneck_reference,
)
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2, init_deeplabv2, valid_logits_hw
from maxsquareloss_torch.predict import make_predict_fn
from maxsquareloss_torch.train.evaluator import evaluate
from maxsquareloss_torch.train.steps import _prepare_inputs, model_config

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
    t0 = time.perf_counter()
    lib = fused_block.build()
    fused_block._library()
    emit({"phase": "build", "kernel": "fused_bottleneck", "library": lib.name,
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
    fused_bottleneck.launches = 0

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
    peak = torch.cuda.max_memory_allocated()
    model.block_fn = fused_bottleneck
    check(seen <= checked, f"kernel launched at unchecked shapes {sorted(seen - checked)}")
    emit({"phase": "slice_summary", "kernel_launches": launches,
          "launch_shapes": sorted(seen), "peak_memory_bytes": peak,
          "peak_memory_gib": peak / 2**30})
    phase_profile(cfg, model, batches[0])
    return {"launches": launches}


def phase_profile(cfg, model, batch) -> None:
    """Device time by kernel name over one eval batch (torch.profiler)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from maxsquareloss_torch.train.steps import make_eval_step

    step = make_eval_step(cfg, model)
    x, y = (torch.from_numpy(a).cuda() for a in batch[:2])
    step(x, y)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    emit({"phase": "profile", "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / (wall * 1e3),
          "top": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                   "calls": e.count} for e in top]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a GPU",
              file=sys.stderr)
        return 1
    phase_environment()
    phase_build()
    checked, kernel = phase_kernels()
    kernel["launches"] = phase_slice(checked)["launches"]
    check(kernel["launches"] > 0, "the main path launched no fused_bottleneck")
    emit({"kernels": [kernel]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
