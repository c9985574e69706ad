"""State-dict conversion between the reference ``.pth`` layout, the JAX
package's ``(params, frozen)`` pytrees and the port's ``DeepLabV2``.

Own copies of ``maxsquareloss_tpu/convert.py``'s ``torch_state_dict_to_pytrees``,
``pytrees_to_torch_state_dict`` and ``_unfold_bn`` (pure numpy, HWIO pytrees),
plus the port's two loaders:

- ``state_dict_from_jax(params, frozen)``: pytrees of numpy arrays → the
  port's state dict (OIHW conv weights, folded BN ``scale``/``bias``).
- ``load_reference_state_dict(model, sd)``: a reference-layout state dict
  (BN as gamma/beta/running_mean/running_var, optional ``module.`` prefix)
  → folded and loaded into ``model``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from maxsquareloss_torch.models.layers import BN_EPS, fold_bn

Array = np.ndarray


def _oihw_to_hwio(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _hwio_to_oihw(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def strip_module_prefix(sd: Mapping[str, Array]) -> dict[str, Array]:
    """Drop the 'module.' prefix nn.DataParallel bakes into checkpoint keys."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


def _fold_bn_from(sd: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    scale, bias = fold_bn(
        np.asarray(sd[f"{prefix}.weight"], np.float32),
        np.asarray(sd[f"{prefix}.bias"], np.float32),
        np.asarray(sd[f"{prefix}.running_mean"], np.float32),
        np.asarray(sd[f"{prefix}.running_var"], np.float32),
    )
    return {"scale": scale, "bias": bias}


def _classifier_from(sd: Mapping[str, Array], layer: str) -> dict[str, Any] | None:
    convs = []
    for i in range(4):
        for stem in (f"{layer}.conv2d_list.{i}", f"{layer}.{i}"):
            if f"{stem}.weight" in sd:
                convs.append({
                    "w": _oihw_to_hwio(np.asarray(sd[f"{stem}.weight"], np.float32)),
                    "b": np.asarray(sd[f"{stem}.bias"], np.float32),
                })
                break
    if not convs:
        return None
    if len(convs) != 4:
        raise ValueError(f"expected 4 ASPP convs for {layer}, got {len(convs)}")
    return {"convs": convs}


def infer_blocks(sd: Mapping[str, Any]) -> tuple[int, ...]:
    """Infer per-stage block counts from state_dict keys (layerL.B.conv1...)."""
    counts = []
    for li in range(1, 5):
        n = 0
        while f"layer{li}.{n}.conv1.weight" in sd:
            n += 1
        counts.append(n)
    return tuple(counts)


def _to_numpy(v) -> Array:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def torch_state_dict_to_pytrees(
    sd: Mapping[str, Any],
    blocks: tuple[int, ...] | None = None,
    num_classes: int | None = None,
) -> tuple[dict, dict]:
    """Reference-layout state dict → (params, frozen) numpy pytrees (HWIO).

    Classifier heads whose class count differs from ``num_classes`` are
    skipped (the reference re-inits heads at a different class count).
    """
    sd = strip_module_prefix({k: _to_numpy(v) for k, v in sd.items()})
    if blocks is None:
        blocks = infer_blocks(sd)
        if not all(n > 0 for n in blocks):
            raise ValueError(f"could not infer blocks: {blocks}")
    params: dict[str, Any] = {
        "conv1": {"w": _oihw_to_hwio(np.asarray(sd["conv1.weight"], np.float32))}
    }
    frozen: dict[str, Any] = {"bn1": _fold_bn_from(sd, "bn1")}
    for li, n_blocks in enumerate(blocks):
        layer = f"layer{li + 1}"
        bps, bfs = [], []
        for bi in range(n_blocks):
            stem = f"{layer}.{bi}"
            bp = {
                ck: {"w": _oihw_to_hwio(np.asarray(sd[f"{stem}.{ck}.weight"], np.float32))}
                for ck in ("conv1", "conv2", "conv3")
            }
            bf = {f"bn{i}": _fold_bn_from(sd, f"{stem}.bn{i}") for i in (1, 2, 3)}
            if f"{stem}.downsample.0.weight" in sd:
                bp["downsample"] = {
                    "w": _oihw_to_hwio(np.asarray(sd[f"{stem}.downsample.0.weight"], np.float32))
                }
                bf["bn_down"] = _fold_bn_from(sd, f"{stem}.downsample.1")
            bps.append(bp)
            bfs.append(bf)
        params[layer] = bps
        frozen[layer] = bfs
    for head in ("layer5", "layer6"):
        cp = _classifier_from(sd, head)
        if cp is not None:
            head_classes = cp["convs"][0]["w"].shape[-1]
            if num_classes is None or head_classes == num_classes:
                params[head] = cp
    return params, frozen


def _unfold_bn(
    scale: Array, bias: Array, eps: float = BN_EPS
) -> dict[str, Array]:
    """Torch BN params that reproduce the folded affine exactly: mean=0,
    var=1, gamma = scale * sqrt(1 + eps), beta = bias."""
    scale = np.asarray(scale, np.float32)
    bias = np.asarray(bias, np.float32)
    return {
        "weight": (scale * np.sqrt(np.float32(1.0 + eps))).astype(np.float32),
        "bias": bias,
        "running_mean": np.zeros_like(scale),
        "running_var": np.ones_like(scale),
        "num_batches_tracked": np.asarray(0, np.int64),
    }


def _walk(params: Mapping[str, Any], frozen: Mapping[str, Any], put_conv, put_bn):
    """Visit every conv and BN of (params, frozen) under its reference key."""
    put_conv("conv1", params["conv1"]["w"])
    put_bn("bn1", frozen["bn1"])
    for li in range(1, 5):
        layer = f"layer{li}"
        if layer not in params:
            continue
        for bi, (bp, bf) in enumerate(zip(params[layer], frozen[layer])):
            stem = f"{layer}.{bi}"
            for ck in ("conv1", "conv2", "conv3"):
                put_conv(f"{stem}.{ck}", bp[ck]["w"])
                put_bn(f"{stem}.bn{ck[-1]}", bf[f"bn{ck[-1]}"])
            if "downsample" in bp:
                put_conv(f"{stem}.downsample.0", bp["downsample"]["w"])
                put_bn(f"{stem}.downsample.1", bf["bn_down"])
    for head in ("layer5", "layer6"):
        if head not in params:
            continue
        for i, conv in enumerate(params[head]["convs"]):
            put_conv(f"{head}.conv2d_list.{i}", conv["w"], conv["b"])


def pytrees_to_torch_state_dict(
    params: Mapping[str, Any],
    frozen: Mapping[str, Any],
    module_prefix: bool = False,
) -> dict[str, Array]:
    """(params, frozen) pytrees → reference-layout state dict (numpy values)."""
    sd: dict[str, Array] = {}

    def put_conv(stem, w, b=None):
        sd[f"{stem}.weight"] = _hwio_to_oihw(w)
        if b is not None:
            sd[f"{stem}.bias"] = np.asarray(b, np.float32)

    def put_bn(prefix, bn):
        for k, v in _unfold_bn(bn["scale"], bn["bias"]).items():
            sd[f"{prefix}.{k}"] = v

    _walk(params, frozen, put_conv, put_bn)
    if module_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return sd


def state_dict_from_jax(
    params: Mapping[str, Any], frozen: Mapping[str, Any]
) -> dict[str, torch.Tensor]:
    """JAX-package (params, frozen) as numpy arrays → the port's state dict."""
    sd: dict[str, torch.Tensor] = {}

    def put_conv(stem, w, b=None):
        sd[f"{stem}.weight"] = torch.from_numpy(_hwio_to_oihw(np.asarray(w, np.float32)))
        if b is not None:
            sd[f"{stem}.bias"] = torch.from_numpy(np.asarray(b, np.float32).copy())

    def put_bn(prefix, bn):
        sd[f"{prefix}.scale"] = torch.from_numpy(np.asarray(bn["scale"], np.float32).copy())
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(bn["bias"], np.float32).copy())

    _walk(params, frozen, put_conv, put_bn)
    return sd


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]):
    """Fold a reference-layout state dict and load it into ``model`` (strict)."""
    params, frozen = torch_state_dict_to_pytrees(sd)
    return model.load_state_dict(state_dict_from_jax(params, frozen))
