"""Evaluation entry point: single- or multi-scale (+flip) val mIoU
(counterpart of ``tools/evaluate.py``), with the JAX CLI's flags plus
``--device``::

    python -m maxsquareloss_torch.tools.evaluate --dataset cityscapes \\
        --pretrained_ckpt_file ./runs/gta5_iw_maxsquare/checkpoint_best.pth \\
        --scales 0.75,1.0,1.25 --flip true

Prints the metric dict as the JAX CLI does (``{'PA': ..., 'MIoU': ...}``)
and ``main`` returns it. It runs on the card; ``--device cpu`` runs the
plain PyTorch versions on the host. Under ``torchrun --nproc_per_node N``
each process evaluates a shard of the split (``--batch_size`` is global)
and rank 0 prints the metrics of the whole split.

``--sp N`` partitions every image's rows over N processes (a space group;
``torchrun --nproc_per_node N``, or dp x N ranks, whose data groups share
the batches): each rank takes its rows of every image and label, the
ranks exchange the halos each op reads (``parallel/spatial.py``), and the
confusion matrices are summed over every rank, so the metrics are the
one-process metrics. ``--device cpu`` runs it over gloo.

``--quantize int8`` evaluates the post-training int8 model
(``models/quantize.py``): calibrated on the first ``--calib_batches``
batches of the split (``--calib_mode``; with several processes each
calibrates on its shard and the ranges take the maximum over the
processes), then evaluated over the whole split, as the JAX CLI does.
"""

from __future__ import annotations

import argparse

from maxsquareloss_torch.config import add_train_args, config_from_args, str2bool
from maxsquareloss_torch.parallel import ddp, spatial
from maxsquareloss_torch.tools.common import (
    default_paths,
    init_distributed,
    load_inference_model,
    make_loader,
)
from maxsquareloss_torch.train.evaluator import evaluate
from maxsquareloss_torch.utils.device import resolve_device
from maxsquareloss_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("evaluate")
    add_train_args(parser)
    parser.add_argument("--scales", default="1.0", help="comma list, e.g. 0.75,1.0,1.25")
    parser.add_argument("--flip", type=str2bool, default=False)
    parser.add_argument("--full_res_labels", type=str2bool, default=False,
                        help="keep labels at native resolution; predictions are"
                             " upsampled to label size")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.pretrained_ckpt_file:
        parser.error("--pretrained_ckpt_file is required")
    init_distributed(cfg)
    device = resolve_device(cfg.device)
    logger = setup_logger(cfg.checkpoint_dir, "evaluate", main=ddp.is_main())
    model = load_inference_model(cfg, device)

    paths = default_paths(args.data_root_path)[cfg.dataset]
    loader = make_loader(
        cfg, cfg.dataset, paths["root"], args.list_path or paths["val"], "val",
        class_16=cfg.class_16, class_13=cfg.class_13,
        full_res_labels=args.full_res_labels,
    )
    if cfg.quantize == "int8":
        from maxsquareloss_torch.models.quantize import quantize_from_loader

        model = quantize_from_loader(cfg, model, loader, logger)
    scales = tuple(float(s) for s in args.scales.split(","))
    out = evaluate(model, cfg, loader, scales=scales, flip=args.flip,
                   synthia_protocol=cfg.class_16, space=spatial.space_group(cfg.sp))
    ev = out.pop("_eval")
    logger.info(" ".join(f"{k}={v:.4f}" for k, v in out.items()))
    if ddp.is_main():
        ev.Print_Every_class_Eval(logger)
        print(out)
    return out


if __name__ == "__main__":
    main()
    ddp.shutdown()
