"""Shared loader and model assembly for the port's CLIs (counterpart of
``tools/common.py``): per-dataset roots and split list paths under one
datasets root, the transform config of a run, the loaders and the
process group. Batch sizes are global: with several processes each loads
a disjoint shard of ``batch / world`` images of every batch, the shard the
JAX package's processes load. Under ``--sp N`` the shards are the data
groups' (``world / N`` of them, ``rank // N`` this rank's): every rank of a
space group loads the same images and takes its rows of them later.
"""

from __future__ import annotations

import os

import torch

from maxsquareloss_torch.config import TrainConfig, check_supported
from maxsquareloss_torch.data.cityscapes import CityscapesDataset
from maxsquareloss_torch.data.crosscity import CrossCityDataset
from maxsquareloss_torch.data.grain_pipeline import GrainSegLoader
from maxsquareloss_torch.data.gta5 import GTA5Dataset
from maxsquareloss_torch.data.loader import SegDataLoader
from maxsquareloss_torch.data.synthia import SynthiaDataset
from maxsquareloss_torch.data.transforms import TransformConfig
from maxsquareloss_torch.parallel import ddp, multihost, spatial

DATASET_CLS = {
    "cityscapes": CityscapesDataset,
    "gta5": GTA5Dataset,
    "synthia": SynthiaDataset,
    "crosscity": CrossCityDataset,
}


def default_paths(data_root: str) -> dict:
    """Default per-dataset roots and list files under a shared datasets root."""
    return {
        name: {
            "root": os.path.join(data_root, folder),
            "train": os.path.join(data_root, folder, "train.txt"),
            "val": os.path.join(data_root, folder, "val.txt"),
        }
        for name, folder in (("cityscapes", "Cityscapes"), ("gta5", "GTA5"),
                             ("synthia", "SYNTHIA"), ("crosscity", "NTHU"))
    }


def transform_cfg(cfg: TrainConfig, target: bool = False) -> TransformConfig:
    return TransformConfig(
        base_size=cfg.target_base_size if target else cfg.base_size,
        crop_size=cfg.target_crop_size if target else cfg.crop_size,
        random_mirror=cfg.random_mirror,
        random_crop=cfg.random_crop,
        gaussian_blur=cfg.gaussian_blur,
        numpy_transform=cfg.numpy_transform,
        device_normalize=cfg.device_normalize,
    )


def make_loader(
    cfg: TrainConfig,
    dataset_name: str,
    root: str,
    list_path: str,
    split: str,
    target: bool = False,
    **dataset_kw,
) -> SegDataLoader | GrainSegLoader:
    if cfg.cache_dir:
        dataset_kw.setdefault("cache_dir", os.path.join(cfg.cache_dir, f"{dataset_name}_{split}"))
    ds = DATASET_CLS[dataset_name](
        root, list_path, split=split, transform_cfg=transform_cfg(cfg, target=target), **dataset_kw
    )
    # validation takes --eval_batch_size when set (metrics are batch-invariant)
    batch, flag = cfg.batch_size, "--batch_size"
    if split != "train" and cfg.eval_batch_size:
        batch, flag = cfg.eval_batch_size, "--eval_batch_size"
    loader_cls = GrainSegLoader if cfg.loader == "grain" else SegDataLoader
    shard_index, shard_count = spatial.data_groups(cfg.sp)
    return loader_cls(
        ds,
        batch_size=ddp.local_batch(batch, flag, cfg.sp),
        shuffle=split == "train",
        num_workers=cfg.num_workers,
        seed=cfg.seed,
        drop_last=split == "train",
        pad_last=split != "train",
        shard_index=shard_index,
        shard_count=shard_count,
    )


def init_distributed(cfg: TrainConfig) -> int:
    """Join the process group that ``torchrun`` or the flags
    ``--coordinator_address/--num_processes/--process_id`` describe (none for
    a process started alone), check the run's options against it and make
    the space groups of ``--sp``; returns the world size."""
    n = multihost.initialize_distributed(cfg.device, cfg.coordinator_address,
                                         cfg.num_processes, cfg.process_id)
    check_supported(cfg)
    spatial.space_group(cfg.sp)
    return n


def load_inference_model(cfg: TrainConfig, device: torch.device):
    """``--pretrained_ckpt_file`` → a model on ``device`` with the heads'
    eval form: any ``.pth`` the trainer reads; heads the file lacks
    (another class count) keep a fresh init."""
    from maxsquareloss_torch.models.deeplabv2 import init_deeplabv2
    from maxsquareloss_torch.train import checkpoint as ckpt_lib
    from maxsquareloss_torch.train.steps import model_config

    model = init_deeplabv2(model_config(cfg, eval_mode=True), torch.Generator().manual_seed(0),
                           device=device)
    ckpt_lib.load_torch_pth(cfg.pretrained_ckpt_file, model, cfg.num_classes)
    return model
