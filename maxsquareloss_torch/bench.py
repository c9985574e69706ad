"""Benchmark entry point of the port (counterpart of ``bench.py``): one
configuration, one JSON line::

    python -m maxsquareloss_torch.bench --mode uda|source|infer|e2e

    {"metric": ..., "value": N, "unit": "images/sec/chip", "extra": {...}}

Modes:
  uda     the multi-level UDA train step (source CE + IW max-square target
          + self-produced guidance) on ``--batch`` source and ``--batch``
          target images (``--concat``: as one forward over both batches,
          the step's ``--concat_batches``); ``--with_infer`` (default on)
          also times single-scale val inference and records it as
          ``value_infer_bf16`` or ``value_infer_fp32``; in bf16,
          ``--fp32_parity`` (default on) also times the JAX bench's fp32
          parity leg: fp32, stage remat, global batch ``lcm(8, chips)``, as
          ``value_fp32_parity``
  source  the supervised step on ``--batch`` source images
  infer   val inference: forward (+``--scales``/``--flip``) + upsample +
          argmax + confusion matrix; ``--label_hw`` larger than ``--hw`` is
          the full-resolution label protocol
  e2e     disk → loader → device UDA training (``experiments/bench_e2e.py``)

``--dtype`` (default bfloat16, as the JAX bench) is the compute dtype,
``--remat stages`` checkpoints each ResNet stage. The JAX bench's int8
serving leg (``value_infer_int8``) is not ported: the line says so in
``extra.infer_int8`` with its ROADMAP item, and carries no such value.

The model is DeepLabV2-ResNet101 (``--blocks`` cuts depth) from random
weights seeded 0; inputs come from ``np.random.default_rng(0)``. Timing:
``--warmup`` steps, then 2 timed passes of ``--steps`` steps, each fenced by
``torch.cuda.synchronize()`` and a host read of the loss. ``value`` is the
best pass, as in the JAX bench; ``extra.step_ms_passes`` holds both, so the
spread is visible. Runs on the card; ``--device cpu`` runs the plain
PyTorch versions on the host.

One process drives one card. Under ``torchrun --nproc_per_node N`` the
global ``--batch`` splits over the N processes (rank r takes rows
``[r*B/N, (r+1)*B/N)`` of the one-process inputs), the train steps run
under DDP, ``value`` is the global rate over N (images/s per chip, as in
the JAX bench), ``extra.chips`` is N and rank 0 alone prints the line. With
one process the line is the one-card line.

``--quantize``, ``--xla_options`` and ``--comparator`` raise.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from maxsquareloss_torch.config import TrainConfig, str2bool
from maxsquareloss_torch.parallel import ddp, multihost
from maxsquareloss_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_report(device: torch.device) -> dict:
    """The device's platform and kind, and the TF32 switches of this run."""
    cuda = device.type == "cuda"
    return {
        "platform": "gpu" if cuda else device.type,
        "device_kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }


def _hw(s: str) -> tuple[int, int]:
    h, w = (int(v) for v in s.split(","))
    return h, w


# the JAX bench's int8 serving leg, which waits on int8 PTQ
INT8_UNPORTED = ("not ported: int8 PTQ waits on ROADMAP Queue 1 item 3 (int8 PTQ and the "
                 "serving export)")


def measure_step_rate(args, device: torch.device, dtype: str | None = None,
                      remat: str | None = None, batch: int | None = None) -> dict:
    """Build, warm up and time one configuration: ``args``'s, or another
    ``dtype``, ``remat`` and global ``batch`` (the fp32 parity leg). Returns
    images/s per chip (the best pass), ms per step of each pass, the last
    loss and peak memory (this rank's)."""
    from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
    from maxsquareloss_torch.train.steps import (
        make_supervised_train_step,
        make_train_state,
        make_uda_train_step,
        model_config,
    )

    h, w = _hw(args.hw)
    batch = args.batch if batch is None else batch
    rows = slice(ddp.rank() * ddp.local_batch(batch, "--batch"),
                 (ddp.rank() + 1) * ddp.local_batch(batch, "--batch"))
    cfg = TrainConfig(
        multi=True, num_classes=19, target_mode="IW_maxsquare", iw_hist=args.iw_hist,
        concat_batches=args.concat,
        compute_dtype=args.dtype if dtype is None else dtype,
        remat=args.remat if remat is None else remat,
        blocks=tuple(int(v) for v in args.blocks.split(",")), batch_size=batch,
        eval_h_chunk=args.eval_h_chunk, device=str(device),
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = init_deeplabv2(model_config(cfg), torch.Generator().manual_seed(0), device=device)
    state = make_train_state(model, cfg)
    rng = np.random.default_rng(0)
    xs = rng.normal(0, 1, size=(batch, h, w, 3)).astype(np.float32)
    ys = rng.integers(-1, 19, size=(batch, h, w)).astype(np.int32)
    xt = rng.normal(0, 1, size=(batch, h, w, 3)).astype(np.float32)
    xs, ys, xt = (torch.from_numpy(a[rows]).to(device) for a in (xs, ys, xt))

    if args.mode == "uda":
        step = make_uda_train_step(cfg)
        run = lambda: step(state, xs, ys, xt)[1]["loss"]  # noqa: E731
        imgs_per_step = 2 * batch  # source + target images
    elif args.mode == "source":
        step = make_supervised_train_step(cfg)
        run = lambda: step(state, xs, ys)[1]["loss"]  # noqa: E731
        imgs_per_step = batch
    elif args.mode == "infer":
        from maxsquareloss_torch.train.evaluator import make_multiscale_eval_step

        if args.label_hw:
            ys = torch.from_numpy(
                rng.integers(-1, 19, size=(batch, *_hw(args.label_hw))).astype(np.int32)[rows]
            ).to(device)
        scales = tuple(float(s) for s in args.scales.split(","))
        estep = make_multiscale_eval_step(cfg, model, scales=scales, flip=args.flip)
        run = lambda: estep(xs, ys)[0][0, 0]  # noqa: E731  (the loss slot: one CM entry)
        imgs_per_step = batch
    else:
        raise ValueError(f"unknown mode {args.mode!r}")

    for _ in range(args.warmup):
        run()
    _sync(device)
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = run()
        _sync(device)
        loss = float(loss)  # host read: the pass is done
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {
        "images_per_sec": imgs_per_step * args.steps / min(seconds) / ddp.world(),
        "step_ms_passes": [1e3 * s / args.steps for s in seconds],
        "final_loss": loss,
        "peak_memory_bytes": peak,
    }


def _check_supported(args) -> None:
    """Raise on every flag whose feature the port does not have."""
    unported = (
        (args.quantize, "--quantize waits on int8 PTQ (ROADMAP Queue 1 item 3)"),
        (args.xla_options is not None, "--xla_options configures XLA, which the port does not use"),
        (args.comparator is not None, "--comparator: the port's JSON carries no comparator "
         "and no vs_baseline"),
    )
    for bad, why in unported:
        if bad:
            raise NotImplementedError(f"not ported: {why}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("bench")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--mode", default="uda", choices=("uda", "source", "infer", "e2e"))
    p.add_argument("--hw", default="512,1024", help="input H,W")
    p.add_argument("--blocks", default="3,4,23,3",
                   help="ResNet stage depths (default R101; smaller for CPU runs)")
    # from random full-R101 weights the default --iw_hist guidance keeps
    # ~0.2 % of the pixels, most classes take the degenerate IW weight 1.0
    # and the UDA step diverges to NaN by its third step (the reference's own
    # multi-arm collapse); a benchmark must report a finite loss, and
    # counting the argmax runs the same kernels
    p.add_argument("--iw_hist", default="argmax", choices=("guidance", "argmax"))
    p.add_argument("--remat", default="", choices=("", "stages"))
    p.add_argument("--concat", action="store_true",
                   help="UDA: one concatenated source+target forward (--concat_batches)")
    p.add_argument("--scales", default="1.0", help="infer mode: comma-separated eval scales")
    p.add_argument("--flip", type=str2bool, default=False, help="infer mode: flip TTA")
    p.add_argument("--label_hw", default="",
                   help="infer mode: label resolution H,W (full-res protocol: "
                        "1024,2048); default = input --hw")
    p.add_argument("--quantize", default="", choices=("", "int8"))
    p.add_argument("--eval_h_chunk", type=int, default=-1,
                   help="infer mode: stream the upsample/argmax/CM tail over output-row "
                        "blocks of this height (-1 = auto: 256 when label H > 512; 0 = off)")
    p.add_argument("--xla_options", default=None)
    p.add_argument("--comparator", type=float, default=None)
    p.add_argument("--fp32_parity", type=str2bool, default=None,
                   help="also time the fp32 parity leg (fp32, stage remat, global batch "
                        "lcm(8, chips)); default: true for --mode uda in bf16")
    p.add_argument("--with_infer", type=str2bool, default=None,
                   help="also time single-scale inference (default: true for --mode uda)")
    p.add_argument("--data_root", default=os.path.join(tempfile.gettempdir(), "bench_e2e_data"),
                   help="e2e mode: on-disk dataset root (synthesized at protocol shapes "
                        "if absent)")
    p.add_argument("--n_per_domain", type=int, default=96,
                   help="e2e mode: images per domain in the synthesized dataset")
    p.add_argument("--epochs", type=int, default=3,
                   help="e2e mode: timed epochs per leg (median reported)")
    p.add_argument("--num_workers", type=int, default=4, help="e2e mode: loader threads")
    p.add_argument("--device_normalize", type=str2bool, default=True,
                   help="e2e mode: ship uint8/int8, normalize on the device")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain PyTorch "
                        "versions of the kernels on the host)")
    args = p.parse_args(argv)
    _check_supported(args)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    multihost.initialize_distributed(args.device)
    device = resolve_device(args.device)
    if args.mode == "e2e":
        from maxsquareloss_torch.experiments.bench_e2e import run_e2e

        result = run_e2e(args)
        if ddp.is_main():
            print(json.dumps(result))
        return result

    h, w = _hw(args.hw)
    tag = "bf16" if args.dtype == "bfloat16" else "fp32"
    m = measure_step_rate(args, device)
    extra = {
        "chips": ddp.world(), "global_batch": args.batch, "blocks": args.blocks, "iw_hist": args.iw_hist,
        "concat_batches": args.concat, "compute_dtype": args.dtype, "remat": args.remat,
        "step_ms": min(m["step_ms_passes"]), "step_ms_passes": m["step_ms_passes"],
        "final_loss": m["final_loss"], "peak_memory_bytes": m["peak_memory_bytes"],
        **device_report(device),
        f"value_{tag}": m["images_per_sec"],
    }
    if args.mode == "infer":
        extra.update(scales=args.scales, flip=args.flip, label_hw=args.label_hw or args.hw,
                     eval_h_chunk=args.eval_h_chunk)
    with_infer = args.mode == "uda" if args.with_infer is None else args.with_infer
    if with_infer and args.mode != "infer":
        iargs = copy.copy(args)
        iargs.mode = "infer"
        inf = measure_step_rate(iargs, device, remat="")
        extra.update({f"value_infer_{tag}": inf["images_per_sec"]}, infer_int8=INT8_UNPORTED,
                     infer_step_ms=min(inf["step_ms_passes"]),
                     infer_step_ms_passes=inf["step_ms_passes"],
                     infer_scales=args.scales, infer_flip=args.flip,
                     infer_label_hw=args.label_hw or args.hw,
                     infer_eval_h_chunk=args.eval_h_chunk)
    do_fp32 = args.fp32_parity
    if do_fp32 is None:
        do_fp32 = args.mode == "uda" and args.dtype == "bfloat16"
    if do_fp32 and args.mode != "infer":
        # fp32 is the parity dtype; the JAX bench takes it at batch 8 with
        # stage remat, scaled to lcm(8, chips) so that it shards evenly
        fp32_batch = math.lcm(8, ddp.world())
        par = measure_step_rate(args, device, dtype="float32", remat="stages", batch=fp32_batch)
        extra.update(fp32_global_batch=fp32_batch, value_fp32_parity=par["images_per_sec"],
                     fp32_step_ms=min(par["step_ms_passes"]),
                     fp32_step_ms_passes=par["step_ms_passes"],
                     fp32_final_loss=par["final_loss"],
                     fp32_peak_memory_bytes=par["peak_memory_bytes"])
    result = {
        "metric": (f"{args.mode}{'_train' if args.mode != 'infer' else ''}"
                   f"_images_per_sec_per_chip_{w}x{h}_{args.dtype}"),
        "value": m["images_per_sec"],
        "unit": "images/sec/chip",
        "extra": extra,
    }
    if ddp.is_main():
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
    ddp.shutdown()
