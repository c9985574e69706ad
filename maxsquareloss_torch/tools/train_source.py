"""Source-only supervised training entry point (counterpart of
``tools/train_source.py``), with the JAX CLI's flags plus ``--device``::

    python -m maxsquareloss_torch.tools.train_source --dataset gta5 \\
        --data_root_path ./datasets --checkpoint_dir ./runs/gta5_source \\
        --base_size 1280,720 --crop_size 1280,640 --iter_max 200000

It runs on the card; ``--device cpu`` runs the plain PyTorch versions of the
kernels on the host (with e.g. ``--blocks 2,2,2,2`` and small sizes).
"""

from __future__ import annotations

import argparse
import os

from maxsquareloss_torch.config import add_train_args, config_from_args
from maxsquareloss_torch.tools.common import default_paths, make_loader
from maxsquareloss_torch.train.trainer import Trainer


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser("train_source")
    add_train_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    paths = default_paths(args.data_root_path)[cfg.dataset]
    train_list = args.list_path or paths["train"]
    train_loader = make_loader(cfg, cfg.dataset, paths["root"], train_list, "train",
                               class_16=cfg.class_16, class_13=cfg.class_13)
    val_loader = None
    if os.path.exists(paths["val"]):
        val_loader = make_loader(cfg, cfg.dataset, paths["root"], paths["val"], "val",
                                 class_16=cfg.class_16, class_13=cfg.class_13)
    trainer = Trainer(cfg, train_loader, val_loader,
                      synthia_protocol=cfg.dataset == "synthia" or cfg.class_16)
    trainer.main()
    return trainer


if __name__ == "__main__":
    main()
