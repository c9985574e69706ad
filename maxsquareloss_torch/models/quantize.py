"""Post-training int8 quantization of the backbone convs, for evaluation
and serving (port of ``maxsquareloss_tpu/models/quantize.py``).

Scheme, as in the JAX package:

- weights: symmetric per-output-channel int8, ``q = rint(w / s_w)``,
  ``s_w[o] = max |w[o]| / 127``;
- activations: symmetric per-tensor int8, each conv site's input range
  calibrated by eager forwards over a few batches (``calibrate``: the
  recorder ``layers._calib_recorder`` sees the tensors the real forward
  computes), as the exact ``max |x|`` or a per-batch percentile;
- compute: an exact int8 x int8 -> int32 product, dequantized per output
  channel in float32 back to the compute dtype (``layers.qconv2d``).
  Frozen BN, ReLU, the residual adds, the stem's maxpool and both ASPP
  heads stay in the float compute dtype.

``quantize_params`` returns a copy of the model whose backbone convs are
``layers.QConv2d`` sites; the evaluator, predict and the export run it with
no change to their code. Training refuses an int8 model
(``train.steps.make_train_state``). Site paths are the JAX package's
(``conv1``, ``layer1.0.conv2``, ``layer2.0.downsample``), so a calibration
dict (the export's sidecar ``calib_amax``) serves both packages.
"""

from __future__ import annotations

import copy
from typing import Iterable, Iterator

import numpy as np
import torch
from torch import nn

from maxsquareloss_torch.models import layers
from maxsquareloss_torch.models.deeplabv2 import eval_form
from maxsquareloss_torch.models.layers import QConv2d
from maxsquareloss_torch.parallel import ddp


def iter_conv_sites(model: nn.Module) -> Iterator[tuple[str, nn.Module]]:
    """(path, conv) for every backbone conv site, in forward order. The
    classifier heads (layer5/layer6) are not sites: they stay float."""
    yield "conv1", model.conv1
    for li in range(1, 5):
        for bi, block in enumerate(getattr(model, f"layer{li}")):
            for name in ("conv1", "conv2", "conv3"):
                yield f"layer{li}.{bi}.{name}", getattr(block, name)
            if block.downsample is not None:
                yield f"layer{li}.{bi}.downsample", block.downsample[0]


def parse_calib_mode(mode: str) -> float | None:
    """'amax' → None; 'p<percentile>' → the percentile as a float
    ('p99.9'; the digit shorthand 'p999' → 99.9, 'p9999' → 99.99: a value
    above 100 is read as the digits of a percentile starting '99.')."""
    if mode == "amax":
        return None
    if not mode.startswith("p"):
        raise ValueError(f"calib_mode must be 'amax' or 'p<percentile>', got {mode!r}")
    q = float(mode[1:])
    while q > 100.0:
        q /= 10.0
    if not 0.0 < q <= 100.0:
        raise ValueError(f"calib_mode percentile out of (0, 100]: {mode!r}")
    return q


def percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q)`` of a float32 tensor (linear interpolation) as
    the JAX package computes it under XLA: the position ``q / 100 * (n - 1)``
    with the division folded into a product by float32 0.01, ``q * (0.01 *
    (n - 1))`` in float32 (the IEEE quotient can sit one ulp away, which
    moves the result between two sparse top values), and the interpolation's
    second product fused into its sum. By order statistics:
    ``torch.quantile`` refuses inputs above 2^24 elements, which layer1's
    activations pass at 1024x512."""
    flat = a.reshape(-1)
    f32 = torch.float32
    n1 = torch.tensor(flat.numel() - 1, dtype=f32)
    pos = torch.tensor(q, dtype=f32) * (torch.tensor(0.01, dtype=f32) * n1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    lo = int(torch.clamp(low, 0, n1).item())
    hi = int(torch.clamp(high, 0, n1).item())
    low_v = torch.kthvalue(flat, lo + 1).values
    high_v = low_v if hi == lo else torch.kthvalue(flat, hi + 1).values
    low_w, high_w = low_w.to(flat.device), high_w.to(flat.device)
    fused = (low_v * low_w).double() + high_v.double() * high_w.double()
    return fused.float()


def calibrate(model: nn.Module, cfg, batches: Iterable, mode: str | None = None,
              ) -> dict[str, float]:
    """Each site's input range over ``batches``: {site path: statistic}.

    The statistic is ``mode`` (default ``cfg.calib_mode``): the exact
    ``max |x|``, or a per-batch ``|x|`` percentile, max-reduced over the
    batches. ``batches`` yields image batches as the eval pipeline ships
    them (uint8 NHWC, or normalized float32, numpy or torch); the
    in-graph normalization (``steps._prepare_inputs``) is applied, so the
    ranges are those the serving graph sees. Eager forwards on the
    model's device (each float identity block as the fused kernel's
    training forward, which shows the recorder its three convs' inputs);
    the heads in their eval form (``deeplabv2.eval_form``)."""
    from maxsquareloss_torch.train.steps import _prepare_inputs

    q = parse_calib_mode(mode if mode is not None else cfg.calib_mode)
    form = eval_form(model)
    by_id = {id(conv): path for path, conv in iter_conv_sites(model)}
    amax: dict[str, torch.Tensor] = {}
    device = next(model.parameters()).device

    def record(conv, x):
        path = by_id.get(id(conv))
        if path is None:  # a head: not a site
            return
        a = x.float().abs()
        m = a.max() if q is None else percentile(a, q)
        amax[path] = m if path not in amax else torch.maximum(amax[path], m)

    if layers._calib_recorder is not None:
        raise RuntimeError("nested calibration")
    layers._calib_recorder = record
    try:
        n = 0
        with torch.inference_mode():
            for xs in batches:
                x, _ = _prepare_inputs(torch.as_tensor(xs).to(device), None, cfg)
                form(x)
                n += 1
        if n == 0:
            raise ValueError("calibrate() needs at least one batch")
    finally:
        layers._calib_recorder = None
    return {p: float(v) for p, v in amax.items()}


def _quantize_site(conv: nn.Conv2d, act_amax: float) -> QConv2d:
    """The int8 site of ``conv`` at input range ``act_amax``, with the JAX
    package's numpy arithmetic: ``s_w`` float32, ``s_a`` a Python float,
    ``oscale = s_w * s_a`` in float32 and ``ascale_inv = 1 / s_a`` in double
    rounded to float32."""
    w = conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
    s_w = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0  # (O,)
    s_w = np.maximum(s_w, 1e-12)
    q = np.clip(np.rint(w / s_w), -127, 127).astype(np.int8)
    s_a = max(float(act_amax), 1e-12) / 127.0
    device = conv.weight.device
    return QConv2d(
        torch.from_numpy(np.ascontiguousarray(q.transpose(3, 2, 0, 1))).to(device),
        torch.from_numpy(np.asarray(s_w * s_a, np.float32)).to(device),
        torch.tensor(np.float32(1.0 / s_a), device=device),
        stride=conv.stride[0], padding=conv.padding[0], dilation=conv.dilation[0],
    )


def _set_site(model: nn.Module, path: str, site: nn.Module) -> None:
    parts = path.split(".")
    if parts[-1] == "downsample":
        getattr(model, parts[0])[int(parts[1])].downsample[0] = site
    elif len(parts) == 1:
        setattr(model, parts[0], site)
    else:
        setattr(getattr(model, parts[0])[int(parts[1])], parts[2], site)


def quantize_params(model: nn.Module, amax_by_path: dict[str, float]) -> nn.Module:
    """A copy of ``model`` whose backbone convs are int8 sites; the heads and
    ``model`` itself are untouched. A site missing from ``amax_by_path``
    raises: a site left float would misreport what "int8" means."""
    sites = [path for path, _ in iter_conv_sites(model)]
    missing = [p for p in sites if p not in amax_by_path]
    if missing:
        raise ValueError(f"no calibration amax for sites: {missing[:4]}...")
    out = copy.deepcopy(model)
    for path, conv in list(iter_conv_sites(out)):
        _set_site(out, path, _quantize_site(conv, amax_by_path[path]))
    out.pack_weights()  # drops the int8 blocks' packed float weights
    return out


def quantize_from_loader(cfg, model: nn.Module, loader, logger=None) -> nn.Module:
    """CLI glue: calibrate on the first ``cfg.calib_batches`` image batches
    of ``loader`` (this process's shard), take the maximum over the
    processes, and return the int8 model."""
    def batches():
        it = iter(loader)
        for _ in range(max(1, cfg.calib_batches)):
            try:
                xs, _, _ = next(it)
            except StopIteration:
                return
            yield xs

    try:
        amax = calibrate(model, cfg, batches())
    except ValueError:
        if ddp.world() == 1:
            raise
        # an empty shard (a split smaller than the process count) must still
        # reach the collective below, or its siblings wait there for ever
        amax = {}
    amax = sync_amax_across_processes(amax, model)
    if logger is not None:
        logger.info(f"int8 PTQ: calibrated {len(amax)} conv sites over "
                    f"{max(1, cfg.calib_batches)} batches; backbone convs now int8 "
                    "(heads stay float)")
    return quantize_params(model, amax)


def sync_amax_across_processes(amax: dict[str, float],
                               model: nn.Module | None = None) -> dict[str, float]:
    """The elementwise maximum of every process's calibration ranges, so
    every process builds the same int8 model from its own shard.

    Every process must call it once, one whose shard gave no batch too
    (with ``amax`` ``{}``): one all-gather of a had-batches flag and the
    sites' ranges in the model's site order (``sorted(amax)`` without a
    model), zeros from an empty shard (neutral under max); when no process
    calibrated, all raise the same error together."""
    if ddp.world() == 1:
        if not amax:
            raise ValueError("no calibration batches on any process")
        return amax
    keys = sorted(amax) if model is None else [path for path, _ in iter_conv_sites(model)]
    vec = torch.tensor([float(bool(amax))] + [amax.get(k, 0.0) for k in keys],
                       dtype=torch.float32)
    g = ddp.all_gather(vec)
    if not bool(g[:, 0].any()):
        raise ValueError("no calibration batches on any process")
    synced = g[:, 1:].max(dim=0).values
    return {k: float(v) for k, v in zip(keys, synced)}
