"""int8 PTQ accuracy at full model scale (counterpart of
``experiments/int8_accuracy.py``, over the port's entry points).

On a DeepLabV2-R101 trained here on the synthetic colour → class dataset
at the protocol's resolution (1024x512), with an in-domain val split so the
float mIoU is high and the deltas mean something, it reports:

- float against int8 **argmax agreement** (share of pixels with the same
  prediction),
- the **mIoU delta** and the **per-class IoU deltas** (19 classes),
- **calibration robustness**: the above for each ``--calib_batches`` x
  ``--calib_modes`` setting (amax against a percentile), and how far each
  site's range moves between the fewest and the most calibration batches.

    # data + train + report, on the card
    python -m maxsquareloss_torch.experiments.int8_accuracy --prepare runs/int8acc \\
        --out runs/int8acc/report.json
    # report only, from a checkpoint
    python -m maxsquareloss_torch.experiments.int8_accuracy \\
        --ckpt runs/int8acc/src/checkpoint_latest.pth --data_root runs/int8acc/data

Training is ``tools.train_source`` called in this process. Runs on the
card; ``--device cpu`` runs the plain PyTorch versions on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def prepare(base: str, a) -> None:
    """Write the protocol-resolution dataset and train the model on it."""
    from maxsquareloss_torch.data.synthetic import write_domain_shift_pair
    from maxsquareloss_torch.tools import train_source

    data = os.path.join(base, "data")
    write_domain_shift_pair(data, n_source=a.n_images, n_target_train=4, n_target_val=a.n_val,
                            hw=(a.h, a.w), patch=32, shift=(0.0, 0.0, 0.0), seed=a.seed)
    train_source.main([
        "--dataset", "gta5", "--data_root_path", data,
        "--checkpoint_dir", os.path.join(base, "src"),
        "--lr", "0.01", "--iter_max", str(a.train_iters), "--iter_stop", str(a.train_iters),
        "--epoch_num", "1000000", "--validation_epoch", "1000000", "--seed", str(a.seed),
        "--blocks", a.blocks, "--batch_size", str(a.batch),
        "--base_size", f"{a.w},{a.h}", "--crop_size", f"{a.w},{a.h}",
        "--compute_dtype", a.compute_dtype, "--num_workers", "4",
        "--gaussian_blur", "false", "--numpy_transform", "false", "--tqdm", "false",
        *([] if a.device is None else ["--device", a.device]),
    ])


def calibrate_batch_stats(model, cfg, batches, modes) -> dict[str, dict[str, list[float]]]:
    """One calibration pass recording each site's statistic per batch for
    every mode: ``calibrate(mode, n batches)`` is the maximum over the first
    n entries, so every (mode, calib_batches) setting comes from one pass."""
    from maxsquareloss_torch.models import layers
    from maxsquareloss_torch.models.deeplabv2 import eval_form
    from maxsquareloss_torch.models.quantize import iter_conv_sites, parse_calib_mode, percentile
    from maxsquareloss_torch.train.steps import _prepare_inputs

    qs = {m: parse_calib_mode(m) for m in modes}
    by_id = {id(conv): path for path, conv in iter_conv_sites(model)}
    stats: dict[str, dict[str, list[float]]] = {m: {} for m in modes}
    cur: dict[str, dict[str, torch.Tensor]] = {}
    device = next(model.parameters()).device

    def record(conv, x):
        path = by_id.get(id(conv))
        if path is None:
            return
        a = x.float().abs()
        for m, q in qs.items():
            v = a.max() if q is None else percentile(a, q)
            cur[m][path] = v if path not in cur[m] else torch.maximum(cur[m][path], v)

    assert layers._calib_recorder is None
    layers._calib_recorder = record
    try:
        with torch.inference_mode():
            for xs in batches:
                for m in modes:
                    cur[m] = {}
                x, _ = _prepare_inputs(torch.as_tensor(xs).to(device), None, cfg)
                eval_form(model)(x)
                for m in modes:
                    for path, v in cur[m].items():
                        stats[m].setdefault(path, []).append(float(v))
    finally:
        layers._calib_recorder = None
    return stats


def make_predict(cfg):
    """(model, uint8 batch) → int32 argmax of the main head upsampled to
    the input size (the JAX harness's single-scale prediction)."""
    from maxsquareloss_torch.models.deeplabv2 import eval_form
    from maxsquareloss_torch.ops.resize import upsample_logits
    from maxsquareloss_torch.train.steps import _prepare_inputs

    @torch.inference_mode()
    def predict(model, xs):
        x, _ = _prepare_inputs(xs, None, cfg)
        _, main = eval_form(model)(x, aux=False)
        return upsample_logits(main, (x.shape[1], x.shape[2])).argmax(-1).int()

    return predict


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("int8_accuracy")
    p.add_argument("--prepare", default="",
                   help="write the dataset and train the checkpoint under this dir")
    p.add_argument("--ckpt", default="")
    p.add_argument("--data_root", default="")
    p.add_argument("--blocks", default="3,4,23,3")
    p.add_argument("--h", type=int, default=512)
    p.add_argument("--w", type=int, default=1024)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n_images", type=int, default=32)
    p.add_argument("--n_val", type=int, default=16)
    p.add_argument("--train_iters", type=int, default=250)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--calib_batches", default="1,4,16")
    p.add_argument("--calib_modes", default="amax,p99.9")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain PyTorch "
                        "versions on the host)")
    a = p.parse_args(argv)

    if a.prepare:
        prepare(a.prepare, a)
        if not a.ckpt:
            from maxsquareloss_torch.train.checkpoint import LATEST

            a.ckpt = os.path.join(a.prepare, "src", LATEST)
            a.data_root = os.path.join(a.prepare, "data")
    if not (a.ckpt and a.data_root):
        p.error("--ckpt and --data_root (or --prepare) are required")

    from maxsquareloss_torch.config import TrainConfig
    from maxsquareloss_torch.metrics import Eval
    from maxsquareloss_torch.models.quantize import calibrate, quantize_params
    from maxsquareloss_torch.tools.common import default_paths, load_inference_model, make_loader
    from maxsquareloss_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    cfg = TrainConfig(
        dataset="cityscapes", blocks=tuple(int(v) for v in a.blocks.split(",")),
        batch_size=a.batch, eval_batch_size=a.batch, base_size=(a.w, a.h),
        crop_size=(a.w, a.h), compute_dtype=a.compute_dtype, num_workers=4,
        numpy_transform=False, pretrained_ckpt_file=a.ckpt, device=str(device),
        checkpoint_dir=os.path.join(a.prepare or os.path.dirname(a.ckpt), "eval"),
    )
    model = load_inference_model(cfg, device)
    paths = default_paths(a.data_root)["cityscapes"]

    def loader():
        return make_loader(cfg, "cityscapes", paths["root"], paths["val"], "val")

    predict = make_predict(cfg)

    def run(m):
        """(Eval, predictions per batch) over the val split."""
        ev, preds = Eval(19), []
        for xs, ys, _ in loader():
            pred = predict(m, torch.as_tensor(xs).to(device)).cpu().numpy()
            ev.add_batch(np.asarray(ys), pred)
            preds.append(pred)
        return ev, preds

    t0 = time.time()
    ev_fp, fp_preds = run(model)
    fp_miou, fp_iou = ev_fp.Mean_Intersection_over_Union(), ev_fp._iou_per_class()
    print(f"fp ({a.compute_dtype}): mIoU {fp_miou:.4f}  [{time.time() - t0:.0f}s]", flush=True)
    report = {"config": vars(a), "fp": {"miou": fp_miou, "iou_per_class": fp_iou.tolist()},
              "variants": {}}

    n_calib = [int(v) for v in a.calib_batches.split(",")]
    arrays = []
    for xs, _, _ in loader():
        if len(arrays) == max(n_calib):
            break
        arrays.append(np.asarray(xs))
    modes = a.calib_modes.split(",")
    t0 = time.time()
    stats = calibrate_batch_stats(model, cfg, arrays, modes)
    print(f"calibration pass: {len(arrays)} batches, {len(modes)} modes "
          f"[{time.time() - t0:.0f}s]", flush=True)
    # the per-batch derivation against the entry point's calibrate on one batch
    ref = calibrate(model, cfg, arrays[:1], mode=modes[0])
    derived = {path: v[0] for path, v in stats[modes[0]].items()}
    assert all(abs(ref[path] - derived[path]) <= 1e-5 * max(1.0, abs(ref[path]))
               for path in ref), "per-batch statistics differ from calibrate()"
    for mode in modes:
        for nb in n_calib:
            tag = f"{mode}/calib{nb}"
            t0 = time.time()
            amax = {path: max(v[:nb]) for path, v in stats[mode].items()}
            ev_q, q_preds = run(quantize_params(model, amax))
            agree = sum(int((q == f).sum()) for q, f in zip(q_preds, fp_preds))
            total = sum(q.size for q in q_preds)
            miou, d = ev_q.Mean_Intersection_over_Union(), ev_q._iou_per_class() - fp_iou
            report["variants"][tag] = {
                "miou": miou, "miou_delta": miou - fp_miou, "argmax_agreement": agree / total,
                "iou_delta_per_class": d.tolist(), "worst_class_delta": float(np.nanmin(d)),
                "calib_batches_read": min(nb, len(arrays)), "amax": amax,
            }
            print(f"int8 {tag}: mIoU {miou:.4f} (delta {miou - fp_miou:+.4f}), argmax "
                  f"agreement {agree / total:.4%}, worst per-class IoU delta "
                  f"{np.nanmin(d):+.4f}  [{time.time() - t0:.0f}s]", flush=True)

    # how far each site's range moves from the fewest to the most batches
    for mode in modes:
        tags = [f"{mode}/calib{nb}" for nb in n_calib]
        if len(tags) < 2:
            continue
        lo, hi = (report["variants"][t]["amax"] for t in (tags[0], tags[-1]))
        ratios = np.asarray([hi[k] / max(lo[k], 1e-12) for k in lo])
        report.setdefault("dispersion", {})[mode] = {
            "from": tags[0], "to": tags[-1], "max_site_ratio": float(ratios.max()),
            "median_site_ratio": float(np.median(ratios))}
        print(f"range dispersion {mode}: {tags[0]} -> {tags[-1]} per-site ratio median "
              f"{np.median(ratios):.3f}, max {ratios.max():.3f}", flush=True)

    report["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else str(device))
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {a.out}")
    return report


if __name__ == "__main__":
    main()
