"""Adaptation efficacy: does the UDA branch improve target mIoU? (counterpart
of ``experiments/adaptation_efficacy.py``, over the port's CLIs).

The reference's claim is that max-square adaptation on unlabeled target
images beats source-only training on the target val split. This harness
measures that effect on the synthetic domain-shift pair
(``data/synthetic.write_domain_shift_pair``) through the port's entry
points, ``tools.train_source``, ``tools.solve_gta5`` and ``tools.evaluate``
(each ``main(argv)`` called in this process), with a held-out labeled target
val split.

Arms, per seed:
  in_domain    the source checkpoint on an unshifted copy of the val split
               (the no-domain-gap upper bound)
  source_only  the source checkpoint on the shifted target val split
  control_l0   the same solve_gta5 run with --lambda_target 0: the same LR
               schedule, data order and source CE, no target term
  maxsquare / IW_maxsquare / IW_maxsquare_multi / entropy ...
               solve_gta5 from the source checkpoint, on the target val split

    python -m maxsquareloss_torch.experiments.adaptation_efficacy --seeds 0,1,2 \\
        --out runs/adapt.json

Runs on the card; ``--device cpu`` runs the plain PyTorch versions on the
host.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import tempfile
import time

from maxsquareloss_torch.train.checkpoint import LATEST

SIZE_FLAGS = ["--base_size", "128,64", "--crop_size", "128,64"]
TGT_SIZE_FLAGS = ["--target_base_size", "128,64", "--target_crop_size", "128,64"]
COMMON = [
    "--blocks", "1,1,2,1", "--batch_size", "8", "--num_workers", "2",
    "--gaussian_blur", "false", "--numpy_transform", "false",
    "--tqdm", "false", "--validation_epoch", "1000000",
]


def run_cli(tool: str, args: list[str], device: str | None):
    """``maxsquareloss_torch.tools.<tool>.main(args)`` on ``device``."""
    main = importlib.import_module(f"maxsquareloss_torch.tools.{tool}").main
    return main([*args, *([] if device is None else ["--device", device])])


def eval_miou(work: str, tag: str, data: str, ckpt: str, seed: int, device: str | None) -> float:
    out = run_cli("evaluate", [
        "--dataset", "cityscapes", "--data_root_path", data,
        "--checkpoint_dir", os.path.join(work, f"eval_{tag}"),
        "--pretrained_ckpt_file", ckpt, "--seed", str(seed),
        *SIZE_FLAGS, *COMMON,
    ], device)
    return out["MIoU"]


def run_seed(work: str, seed: int, a) -> dict[str, float]:
    from maxsquareloss_torch.data.synthetic import write_domain_shift_pair

    shift = tuple(float(v) for v in a.shift.split(","))
    gen_kw = dict(
        n_source=a.n_images, n_target_train=a.n_images, n_target_val=a.n_val,
        sigma=a.sigma, spacing=a.spacing, patch=a.patch, seed=seed,
    )
    data = os.path.join(work, "data")
    write_domain_shift_pair(data, shift=shift, **gen_kw)
    # unshifted copy of the target domain: the in-domain upper bound
    data_id = os.path.join(work, "data_indomain")
    write_domain_shift_pair(data_id, shift=(0.0, 0.0, 0.0), **gen_kw)

    res: dict[str, float] = {}
    t0 = time.time()
    src_dir = os.path.join(work, "src")
    run_cli("train_source", [
        "--dataset", "gta5", "--data_root_path", data,
        "--checkpoint_dir", src_dir, "--lr", str(a.lr_src),
        "--iter_max", str(a.iters_src), "--iter_stop", str(a.iters_src),
        "--epoch_num", "1000000", "--seed", str(seed),
        *SIZE_FLAGS, *COMMON,
    ], a.device)
    src_ckpt = os.path.join(src_dir, LATEST)
    res["in_domain"] = eval_miou(work, "indom", data_id, src_ckpt, seed, a.device)
    res["source_only"] = eval_miou(work, "src", data, src_ckpt, seed, a.device)

    def run_uda(tag: str, target_mode: str, multi: bool, lam: float,
                thr: float | None = None, iw_hist: str | None = None) -> float:
        uda_dir = os.path.join(work, f"uda_{tag}")
        extra = [] if thr is None else ["--threshold", str(thr)]
        if iw_hist is not None:
            extra += ["--iw_hist", iw_hist]
        run_cli("solve_gta5", [
            "--source_dataset", "gta5", "--data_root_path", data,
            "--checkpoint_dir", uda_dir, "--target_mode", target_mode,
            "--multi", str(multi).lower(), "--lr", str(a.lr_uda),
            "--lambda_target", str(lam), *extra,
            "--pretrained_ckpt_file", src_ckpt,
            "--iter_max", str(a.iters_uda), "--iter_stop", str(a.iters_uda),
            "--epoch_num", "1000000", "--seed", str(seed),
            *SIZE_FLAGS, *TGT_SIZE_FLAGS, *COMMON,
        ], a.device)
        return eval_miou(work, tag, data, os.path.join(uda_dir, LATEST), seed, a.device)

    if not a.skip_control:
        res["control_l0"] = run_uda("control_l0", "maxsquare", False, 0.0)
    for spec in a.modes.split(","):
        # per-arm overrides "mode[@LAM][@tTHR][@hargmax]": LAM overrides
        # --lambda_target, tTHR the guidance --threshold, hargmax sets
        # --iw_hist argmax (e.g. "IW_maxsquare_multi@64@t0.8")
        parts = spec.split("@")
        mode, lam, thr, iw_hist = parts[0], a.lambda_target, None, None
        for tok in parts[1:]:
            if tok == "hargmax":
                iw_hist = "argmax"
            elif tok.startswith("t"):
                thr = float(tok[1:])
            else:
                lam = float(tok)
        target_mode, multi = mode, False
        if mode.endswith("_multi"):
            target_mode, multi = mode[: -len("_multi")], True
        key = mode
        if lam != a.lambda_target:
            key += f"@{lam:g}"
        if thr is not None:
            key += f"@t{thr:g}"
        if iw_hist is not None:
            key += "@hargmax"
        res[key] = run_uda(key.replace("@", "_").replace(".", "p"), target_mode, multi,
                           lam, thr, iw_hist)
    res["_wall_s"] = time.time() - t0
    return res


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("adaptation_efficacy")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--modes", default="maxsquare,IW_maxsquare,IW_maxsquare_multi")
    p.add_argument("--iters_src", type=int, default=300)
    p.add_argument("--iters_uda", type=int, default=200)
    p.add_argument("--lr_src", type=float, default=0.01)
    p.add_argument("--lr_uda", type=float, default=0.002)
    p.add_argument("--lambda_target", type=float, default=0.09)
    p.add_argument("--n_images", type=int, default=32)
    p.add_argument("--n_val", type=int, default=16)
    p.add_argument("--sigma", type=float, default=18.0)
    p.add_argument("--spacing", type=float, default=80.0)
    p.add_argument("--patch", type=int, default=16)
    p.add_argument("--shift", default="24,-24,24")
    p.add_argument("--device", default=None,
                   help="torch device of every CLI (default: the card; 'cpu' runs the "
                        "plain PyTorch versions on the host)")
    p.add_argument("--out", default="")
    p.add_argument("--keep_work", action="store_true")
    p.add_argument("--skip_control", action="store_true",
                   help="skip the lambda_target=0 control arm")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    all_res: dict[str, dict] = {}
    for seed in (int(s) for s in a.seeds.split(",")):
        work = tempfile.mkdtemp(prefix=f"adapt_s{seed}_")
        try:
            all_res[str(seed)] = run_seed(work, seed, a)
            print(f"seed {seed}: {json.dumps(all_res[str(seed)])}", flush=True)
        finally:
            if not a.keep_work:
                shutil.rmtree(work, ignore_errors=True)

    arms = [k for k in next(iter(all_res.values())) if not k.startswith("_")]
    summary = {
        arm: {"mean": sum(r[arm] for r in all_res.values()) / len(all_res),
              "per_seed": [r[arm] for r in all_res.values()]}
        for arm in arms
    }
    print("\n== adaptation efficacy (target-val mIoU) ==")
    for arm in arms:
        s = summary[arm]
        print(f"  {arm:20s} mean {s['mean']:.4f}  per-seed {[round(v, 4) for v in s['per_seed']]}")
    result = {"config": vars(a), "per_seed": all_res, "summary": summary}
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
