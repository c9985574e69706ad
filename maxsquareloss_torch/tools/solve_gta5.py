"""UDA training entry point, GTA5 or SYNTHIA → Cityscapes (counterpart of
``tools/solve_gta5.py``), with the JAX CLI's flags plus ``--device``::

    python -m maxsquareloss_torch.tools.solve_gta5 --source_dataset gta5 \\
        --target_mode IW_maxsquare --lambda_target 0.09 --IW_ratio 0.2 \\
        --pretrained_ckpt_file ./runs/gta5_source/checkpoint_latest.pth \\
        --checkpoint_dir ./runs/gta5_iw_maxsquare

Starts from a source-pretrained model (any ``.pth`` the trainer reads),
adapts on unlabeled Cityscapes train and validates on Cityscapes val
(19-class, or the 16/13-class protocol when the source is SYNTHIA). It runs
on the card; ``--device cpu`` runs the plain PyTorch versions on the host.

Under ``torchrun --nproc_per_node N`` (or with ``--coordinator_address
--num_processes --process_id``) it trains data-parallel, one process per
card (``--device cpu``: gloo on the host); batch sizes are global.
"""

from __future__ import annotations

import argparse
import os

from maxsquareloss_torch.config import add_train_args, add_uda_train_args, config_from_args
from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.tools.common import default_paths, init_distributed, make_loader
from maxsquareloss_torch.train.uda_trainer import UDATrainer


def build_uda_trainer(args, cfg) -> UDATrainer:
    paths = default_paths(args.data_root_path)
    src_name = args.source_dataset
    src = paths[src_name]
    tgt = paths["cityscapes"]
    src_root = args.source_data_path or src["root"]
    src_list = args.source_list_path or src["train"]
    tgt_root = args.target_data_path or tgt["root"]
    tgt_list = args.target_list_path or tgt["train"]

    synthia = src_name == "synthia"
    source_loader = make_loader(cfg, src_name, src_root, src_list, "train", class_16=synthia)
    target_loader = make_loader(cfg, "cityscapes", tgt_root, tgt_list, "train", target=True,
                                class_16=synthia)
    val_loader = None
    if os.path.exists(tgt["val"]):
        val_loader = make_loader(cfg, "cityscapes", tgt_root, tgt["val"], "val", target=True,
                                 class_16=synthia)
    return UDATrainer(cfg, source_loader, target_loader, val_loader, synthia_protocol=synthia)


def main(argv=None) -> UDATrainer:
    parser = argparse.ArgumentParser("solve_gta5")
    add_train_args(parser)
    add_uda_train_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    init_distributed(cfg)
    trainer = build_uda_trainer(args, cfg)
    trainer.main()
    return trainer


if __name__ == "__main__":
    main()
    ddp.shutdown()
