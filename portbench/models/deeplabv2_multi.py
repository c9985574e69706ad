"""DeepLabV2-ResNet101, multi-level (the aux head on layer3), as the
MaxSquareLoss code defines it: the port's ``models/deeplabv2.py`` under
test, ``reference/deeplabv2.py`` as its plain forward, SGD as its
optimizer, and its work counted by ``flops.py``."""

from __future__ import annotations

import functools

import torch

from maxsquareloss_torch.config import TrainConfig
from maxsquareloss_torch.convert import load_reference_state_dict
from maxsquareloss_torch.models.deeplabv2 import DeepLabV2
from maxsquareloss_torch.train.steps import model_config
from portbench import flops, harness
from portbench.reference import deeplabv2 as ref
from portbench.reference import uda


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Reference-layout float32 weights on ``device`` from the seed, in two
    draws: trunk convs He-normal (fan out), head convs N(0, 0.01), head
    biases 0; frozen BN with mean 0, var 1, beta 0 and gamma 1 (bn3's
    ``init.bn3_gamma``, so that 33 residual blocks keep activations finite)."""
    lay = ref.layout(model["blocks"], model["num_classes"], model["multi"])
    convs = [(k, s) for k, s in lay if len(s) == 4]
    rest = [(k, s) for k, s in lay if len(s) != 4]

    def std(key, shape):
        if ref.head_param(key):
            return model["init"]["heads_std"]
        return (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5

    def const(key):
        if key.endswith("running_var"):
            return 1.0
        if key.endswith(".weight") and ".bn3." in key:
            return model["init"]["bn3_gamma"]
        if key.endswith(".weight"):
            return 1.0
        return 0.0

    counts = torch.tensor([torch.Size(s).numel() for _, s in convs], device=device)
    scale = torch.repeat_interleave(
        torch.tensor([std(k, s) for k, s in convs], device=device), counts)
    flat = torch.randn(int(counts.sum()), generator=harness.generator(seed, "weights", device),
                       device=device).mul_(scale)
    rcounts = torch.tensor([torch.Size(s).numel() for _, s in rest], device=device)
    rflat = torch.repeat_interleave(torch.tensor([const(k) for k, _ in rest], device=device),
                                    rcounts)
    sd, off, roff = {}, 0, 0
    for k, s in lay:
        n = torch.Size(s).numel()
        if len(s) == 4:
            sd[k], off = flat[off:off + n].view(s), off + n
        else:
            sd[k], roff = rflat[roff:roff + n].view(s), roff + n
    return sd


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


def port_int8(model: DeepLabV2, cfg: TrainConfig, images: list) -> DeepLabV2:
    """The port's int8 path (``models/quantize.py``), calibrated on
    ``images``."""
    from maxsquareloss_torch.models.quantize import calibrate, quantize_params

    return quantize_params(model, calibrate(model, cfg, images))


def port_params(model: DeepLabV2) -> dict:
    """The port names its parameters by the reference's keys."""
    return dict(model.named_parameters())


def first_gradient_norms(optimizer, params: dict, sd0: dict, cfg: TrainConfig) -> dict:
    """SGD's momentum buffer after one step is ``g + wd * p0`` (none: a
    leaf without gradient, norm 0)."""
    wd = cfg.weight_decay
    bufs = {k: optimizer.state.get(p, {}).get("momentum_buffer") for k, p in params.items()}
    return {k: torch.zeros((), dtype=torch.float64) if b is None
            else (b - wd * sd0[k]).double().norm() for k, b in bufs.items()}


def reference(model: dict) -> uda.Plain:
    return uda.Plain(forward=functools.partial(_forward, blocks=tuple(model["blocks"])),
                     trainable=ref.trainable,
                     optimizer=functools.partial(uda.SGD, is_head=ref.head_param))


def _forward(sd, x, aux: bool = True, quant=None, *, blocks):
    return ref.forward(sd, x, blocks, aux=aux, quant=quant)


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def step_work(cell) -> dict:
    m, tr, t = cell.config["model"], cell.config["train"], cell.traffic
    n, peak = t["batch"], cell.peaks["flops"][t["dtype"]]
    (sw, sh), (tw, th) = tr["crop_size"], tr["target_crop_size"]
    blocks = (flops.identity_blocks(m["blocks"], n, (sh, sw))
              + flops.identity_blocks(m["blocks"], n, (th, tw)))
    return {
        "model_flops": flops.uda_step_flops(m["blocks"], m["num_classes"], n, (sh, sw), n,
                                            (th, tw)),
        "peak_flops": peak,
        "identity_blocks": {"launches": [flops.identity_block_work(b, True,
                                                                   _itemsize(t["dtype"]))
                                         for b in blocks], "peak_flops": peak},
    }


def tta_work(cell, n: int) -> dict:
    m, ev, t = cell.config["model"], cell.config["eval"], cell.traffic
    peak = cell.peaks["flops"][t["dtype"]]
    hw = tuple(ev["base_size"][::-1])
    scales, flip = tuple(t["scales"]), bool(t["flip"])
    views = 2 if flip else 1
    blocks = [b for s in scales
              for b in flops.identity_blocks(m["blocks"], n * views,
                                             (round(hw[0] * s), round(hw[1] * s)))]
    return {"model_flops": flops.tta_flops(m["blocks"], m["num_classes"], n, hw, scales, flip),
            "peak_flops": peak,
            "identity_blocks": {"launches": [flops.identity_block_work(b, False,
                                                                       _itemsize(t["dtype"]))
                                             for b in blocks], "peak_flops": peak}}
