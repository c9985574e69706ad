"""Device resolution for the port's entry points (counterpart of
``maxsquareloss_tpu/utils/runtime.py``'s process-level knobs).

There is no silent CPU fallback: a caller that names no device gets the
card, and an error when there is none. With several processes, the card
is this process's own: ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import functools
import logging
import os

import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device of this process. ``None`` or ``"cuda"``: the card
    ``cuda:LOCAL_RANK`` (``torchrun``'s; else the rank modulo the node's
    cards), made the thread's current device (a kernel launched through
    ``ctypes`` runs on the current device); it raises without a card.
    ``"cuda:k"`` is taken as given (and made current); anything else
    (``"cpu"``) as given."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' explicitly to run the "
                           "plain PyTorch path on the host")
    count = torch.cuda.device_count()
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if dev is None or dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank % count)))
    if dev.index >= count:
        raise RuntimeError(f"rank {rank} wants {dev}, but this node has {count} card(s)")
    torch.cuda.set_device(dev)
    if world == 1 and count > 1:
        _hint_torchrun(count)
    return dev


@functools.cache
def _hint_torchrun(count: int) -> None:
    """Say once how to use every card: a process never starts ranks of its
    own."""
    _log.warning(f"one process uses 1 of {count} cards; `torchrun --nproc_per_node {count} "
                 "-m <entry point> ...` trains over all of them (batch sizes are global)")
