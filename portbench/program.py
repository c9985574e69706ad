"""The system under test, as the benchmark builds it: the port's run
configuration from a cell's files, and the port's model loaded from the
benchmark's reference-layout weights through ``convert``."""

from __future__ import annotations

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.convert import load_reference_state_dict
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2
from maxsquareloss_torch.train.steps import model_config


def train_config(cell, device) -> TrainConfig:
    m, t = cell.config["model"], cell.config["train"]
    return TrainConfig(
        num_classes=m["num_classes"], blocks=tuple(m["blocks"]), multi=m["multi"],
        compute_dtype=cell.traffic["dtype"],
        target_mode=t["target_mode"], ratio=t["IW_ratio"], lambda_target=t["lambda_target"],
        lambda_seg=t["lambda_seg"], threshold=t["threshold"], guidance_mask=t["guidance_mask"],
        iw_hist=t["iw_hist"], lr=t["lr"], momentum=t["momentum"],
        weight_decay=t["weight_decay"], iter_max=t["iter_max"], poly_power=t["poly_power"],
        batch_size=cell.traffic.get("batch", t["batch_size"]),
        numpy_transform=t["numpy_transform"], device=str(device),
    )


def port_model(cfg: TrainConfig, sd: dict, device, eval_mode: bool) -> DeepLabV2:
    """The port's model with the weights ``sd``: built on the device (its own
    init is overwritten), channels_last, in eval mode as the entry points
    keep it; the heads' eval form for evaluation and serving."""
    with torch.device(device):
        model = DeepLabV2(model_config(cfg, eval_mode=eval_mode))
    model = model.to(memory_format=torch.channels_last).eval()
    load_reference_state_dict(model, sd)
    return model
