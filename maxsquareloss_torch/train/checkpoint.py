"""Checkpoint save / load / resume in the reference ``.pth`` layout (the
port's counterpart of ``maxsquareloss_tpu/train/checkpoint.py``).

A training checkpoint is one ``torch.save`` file, ``checkpoint_latest.pth``
(and ``checkpoint_best.pth``), holding the reference's keys::

    {epoch, iteration, state_dict, optimizer, best_MIou, epoch_batch}

``state_dict`` has the reference's parameter names and BN as
gamma/beta/running_mean/running_var (``convert.reference_state_dict``,
exact: loading it gives back the same float32 bits). ``optimizer`` is
torch's SGD state keyed by parameter NAME, not by position:
``{"state": {name: {"momentum_buffer": t}}, "param_groups": [...]}``, so
the momentum buffers survive a round trip into any model with the same
names. ``epoch`` counts completed epochs; ``epoch_batch`` the batches
consumed of the next one (mid-epoch saves). A save writes a temporary file
and ``os.replace``s it, so a crash never leaves a torn checkpoint; it is
synchronous, so there is nothing to wait for.

``load_weights`` takes a bare state dict, a ``module.``-prefixed one (the
reference's DataParallel checkpoints) or a full checkpoint; heads whose
class count differs keep their fresh init, as the reference re-inits its
classifiers on a class change.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from maxsquareloss_torch.convert import (
    reference_state_dict,
    state_dict_from_jax,
    torch_state_dict_to_pytrees,
)

LATEST = "checkpoint_latest.pth"
BEST = "checkpoint_best.pth"
HEADS = ("layer5.", "layer6.")


def optimizer_state_by_name(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """torch's SGD state with every parameter named instead of numbered."""
    names = {id(p): n for n, p in model.named_parameters()}
    state = {
        names[id(p)]: {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
                       for k, v in s.items()}
        for p, s in optimizer.state.items()
    }
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [names[id(p)] for p in g["params"]]}
              for g in optimizer.param_groups]
    return {"state": state, "param_groups": groups}


def restore_optimizer_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                            saved: dict) -> None:
    """Put name-keyed SGD state back, each buffer in its parameter's layout."""
    params = dict(model.named_parameters())
    optimizer.state.clear()
    for name, s in saved["state"].items():
        p = params[name]
        optimizer.state[p] = {
            k: torch.empty_like(p).copy_(v) if isinstance(v, torch.Tensor) else v
            for k, v in s.items()
        }
    for group, saved_group in zip(optimizer.param_groups, saved["param_groups"]):
        if [params[n] for n in saved_group["params"]] != group["params"]:
            raise ValueError("checkpoint optimizer groups do not match the model's")
        group.update({k: v for k, v in saved_group.items() if k != "params"})


def is_training_checkpoint(blob: Any) -> bool:
    """A checkpoint this module wrote: resumable state keyed by name."""
    opt = blob.get("optimizer") if isinstance(blob, dict) else None
    return (isinstance(opt, dict) and "iteration" in blob
            and all(isinstance(k, str) for k in opt.get("state", {})))


def save_checkpoint(
    checkpoint_dir: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    iteration: int,
    epoch: int,
    best_miou: float,
    is_best: bool = False,
    epoch_batch: int = 0,
) -> str:
    """Write ``checkpoint_latest.pth`` (and ``checkpoint_best.pth``)
    atomically; returns the latest path."""
    blob = {
        "epoch": int(epoch),
        "iteration": int(iteration),
        "state_dict": reference_state_dict(model),
        "optimizer": optimizer_state_by_name(model, optimizer),
        "best_MIou": float(best_miou),
        "epoch_batch": int(epoch_batch),
    }
    os.makedirs(checkpoint_dir, exist_ok=True)
    paths = [os.path.join(checkpoint_dir, LATEST)]
    if is_best:
        paths.append(os.path.join(checkpoint_dir, BEST))
    for path in paths:
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
    return paths[0]


def load_checkpoint(path: str) -> Any:
    """The object a ``.pth`` file holds, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_weights(model: torch.nn.Module, blob: Any, num_classes: int | None = None) -> list[str]:
    """Load the weights of ``blob`` (bare, ``module.``-prefixed or a full
    checkpoint) into ``model``; heads of another class count are skipped,
    and so is a head the model lacks (the aux head of a multi-level file in
    a ``--multi false`` model, which the JAX package carries along unused).
    Repacks the eval kernel's weights. Returns the keys left at init."""
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    params, frozen = torch_state_dict_to_pytrees(sd, num_classes=num_classes)
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params, frozen), strict=False)
    if any(not k.startswith(HEADS) for k in (*missing, *unexpected)):
        raise ValueError(f"checkpoint does not fit the model: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    model.pack_weights()
    return missing


def load_torch_pth(path: str, model: torch.nn.Module, num_classes: int | None = None) -> list[str]:
    """``load_weights`` from a file."""
    return load_weights(model, load_checkpoint(path), num_classes)
