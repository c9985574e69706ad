"""Qualitative inference: write trainId and colourized prediction PNGs
(counterpart of ``tools/predict.py``), with the JAX CLI's flags plus
``--device``. Labels are not read: the tool runs single- or multi-scale
(+flip) inference over a split list of images and writes, per image,

  <out>/<name>_trainids.png   (uint8 trainIds; 255 = ignore)
  <out>/<name>_color.png      (Cityscapes palette)

    python -m maxsquareloss_torch.tools.predict --dataset cityscapes \\
        --data_root_path ./datasets --output_dir ./preds \\
        --pretrained_ckpt_file ./runs/gta5_iw/checkpoint_best.pth \\
        --scales 0.75,1.0,1.25 --flip true

It runs on the card; ``--device cpu`` runs the plain PyTorch versions on
the host. ``main`` returns the number of images written. It runs as one
process, or with ``--sp N`` as exactly N processes, one space group (the
JAX tool's (1, sp) mesh: it predicts one image at a time, so its only
scale-out is the image's rows): each rank loads the image, takes its rows
(``parallel/spatial.py``), and rank 0 gathers the trainIds' rows and
writes the files; ``torchrun --nproc_per_node N -m
maxsquareloss_torch.tools.predict --sp N ...`` (``--device cpu``: gloo).
Any other number of processes raises. ``--quantize int8`` predicts with the post-training
int8 model (``models/quantize.py``), calibrated on the first
``--calib_batches`` images of the list, one at a time through the
transform the predictions use, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from maxsquareloss_torch.config import add_train_args, config_from_args, str2bool
from maxsquareloss_torch.data.palette import decode_labels
from maxsquareloss_torch.data.transforms import img_transform
from maxsquareloss_torch.parallel import ddp, spatial
from maxsquareloss_torch.parallel.multihost import launched_world
from maxsquareloss_torch.predict import make_predict_fn
from maxsquareloss_torch.tools.common import default_paths, init_distributed, load_inference_model
from maxsquareloss_torch.utils.device import resolve_device
from maxsquareloss_torch.utils.logging import setup_logger


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("predict")
    add_train_args(parser)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--scales", default="1.0", help="comma list, e.g. 0.75,1.0,1.25")
    parser.add_argument("--flip", type=str2bool, default=False)
    parser.add_argument("--native_size_output", type=str2bool, default=True,
                        help="write predictions at each image's native size "
                             "(logits upsampled align-corners); false = base_size")
    args = parser.parse_args(argv)
    world = launched_world(args.num_processes)
    if world > 1 and world != args.sp:
        raise NotImplementedError(
            f"predict runs as one process, not {world}: it predicts one image at a time, "
            "and its only scale-out is --sp N, as exactly N processes (one space group)")
    cfg = config_from_args(args)
    if not cfg.pretrained_ckpt_file:
        parser.error("--pretrained_ckpt_file is required")
    init_distributed(cfg)
    space = spatial.space_group(cfg.sp)
    main_rank = space is None or space.index == 0
    device = resolve_device(cfg.device)
    logger = setup_logger(args.output_dir, "predict", main=main_rank)
    model = load_inference_model(cfg, device)

    from PIL import Image

    paths = default_paths(args.data_root_path)[cfg.dataset]
    list_path = args.list_path or paths["val"]
    with open(list_path) as f:
        items = [ln.split()[0] for ln in f if ln.strip()]

    def load(rel):
        """(the image's native (W, H), its normalized batch of one at base size)."""
        pil = Image.open(os.path.join(paths["root"], rel)).convert("RGB")
        native_wh = pil.size
        if pil.size != tuple(cfg.base_size):
            pil = pil.resize(cfg.base_size, Image.BICUBIC)
        return native_wh, img_transform(pil, cfg.numpy_transform)[None]

    if cfg.quantize == "int8":
        from maxsquareloss_torch.models.quantize import calibrate, quantize_params

        amax = calibrate(model, cfg, (load(rel)[1] for rel in items[: max(1, cfg.calib_batches)]))
        model = quantize_params(model, amax)
        logger.info(f"int8 PTQ: calibrated {len(amax)} conv sites; backbone convs now int8 "
                    "(heads stay float)")

    scales = tuple(float(s) for s in args.scales.split(","))
    fns: dict[tuple[int, int], object] = {}  # one predict function per output size
    n = 0
    for rel in items:
        native_wh, x = load(rel)
        out_wh = native_wh if args.native_size_output else tuple(cfg.base_size)
        out_hw = (out_wh[1], out_wh[0])
        if out_hw not in fns:
            fns[out_hw] = make_predict_fn(cfg, model, scales, args.flip, out_hw, space)
        if space is None:
            pred = fns[out_hw](torch.from_numpy(x).to(device))
        else:
            # this rank's rows, sliced on the host; rank 0 gathers the output
            a, b = space.own(x.shape[1])
            pred = fns[out_hw](torch.from_numpy(x[:, a:b]).to(device), x.shape[1])
            pred = spatial.gather_rows(pred, out_hw[0], space)
            if not main_rank:
                continue
        pred = pred[0].cpu().numpy()

        name = os.path.splitext(os.path.basename(rel))[0]
        ids = np.where(pred < 0, 255, pred).astype(np.uint8)
        Image.fromarray(ids).save(os.path.join(args.output_dir, f"{name}_trainids.png"))
        color = decode_labels(pred[None])[0].astype(np.uint8)
        Image.fromarray(color).save(os.path.join(args.output_dir, f"{name}_color.png"))
        n += 1
        if n % 50 == 0:
            logger.info(f"{n}/{len(items)} predicted")
    logger.info(f"wrote {n} predictions to {args.output_dir}")
    return n


if __name__ == "__main__":
    main()
    ddp.shutdown()
