"""Cross-city UDA entry point: Cityscapes → NTHU {Rio, Rome, Tokyo, Taipei}
(counterpart of ``tools/solve_crosscity.py``), with the JAX CLI's flags plus
``--device``::

    python -m maxsquareloss_torch.tools.solve_crosscity --city_name Rio \\
        --target_mode IW_maxsquare \\
        --pretrained_ckpt_file ./runs/cityscapes_source/checkpoint_latest.pth

The 13-class protocol: the source is labeled Cityscapes train (its 13
classes compacted to 0..12), the target the chosen city's unlabeled train
split, validation the city's small labeled split. It runs on the card;
``--device cpu`` runs the plain PyTorch versions on the host.

Under ``torchrun --nproc_per_node N`` (or with ``--coordinator_address
--num_processes --process_id``) it trains data-parallel, one process per
card (``--device cpu``: gloo on the host); batch sizes are global.
"""

from __future__ import annotations

import argparse
import os

from maxsquareloss_torch.config import add_train_args, add_uda_train_args, config_from_args
from maxsquareloss_torch.data.crosscity import CITIES
from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.tools.common import default_paths, init_distributed, make_loader
from maxsquareloss_torch.train.uda_trainer import UDATrainer


def main(argv=None) -> UDATrainer:
    parser = argparse.ArgumentParser("solve_crosscity")
    add_train_args(parser)
    add_uda_train_args(parser)
    parser.add_argument("--city_name", default="Rio", choices=CITIES)
    parser.set_defaults(num_classes=13, class_13=True)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    init_distributed(cfg)

    paths = default_paths(args.data_root_path)
    cs, nthu = paths["cityscapes"], paths["crosscity"]
    city = dict(city_name=args.city_name, relabel_13=True)
    source_loader = make_loader(
        cfg, "cityscapes", args.source_data_path or cs["root"],
        args.source_list_path or cs["train"], "train", class_13=True, relabel_13=True,
    )
    target_loader = make_loader(
        cfg, "crosscity", args.target_data_path or nthu["root"],
        args.target_list_path or nthu["train"], "train", target=True, **city,
    )
    val_loader = None
    if os.path.exists(nthu["val"]):
        val_loader = make_loader(cfg, "crosscity", args.target_data_path or nthu["root"],
                                 nthu["val"], "val", target=True, **city)
    trainer = UDATrainer(cfg, source_loader, target_loader, val_loader)
    trainer.main()
    return trainer


if __name__ == "__main__":
    main()
    ddp.shutdown()
