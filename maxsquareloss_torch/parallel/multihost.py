"""Several processes over one or more nodes (the port's counterpart of
``maxsquareloss_tpu/parallel/multihost.py``).

The JAX package joins its processes with ``jax.distributed.initialize`` and
builds a (dcn, ici) mesh whose gradient reduction runs within a slice
first. Here NCCL's collectives are hierarchical by themselves, so there is
no 2-D mesh to build: every process joins one group, and DDP averages over
it. Two ways in:

- ``torchrun`` (one node with ``--nproc_per_node N``, or several with
  ``--nnodes``): its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) is enough;
- the JAX CLIs' flags ``--coordinator_address host:port --num_processes N
  --process_id i``: ``tcp://host:port``, world size N, rank i (the card is
  ``LOCAL_RANK`` when set, else the rank modulo the node's cards).
"""

from __future__ import annotations

import os

import torch

from maxsquareloss_torch.parallel import ddp
from maxsquareloss_torch.utils.device import resolve_device


def backend_for(device: str | torch.device | None) -> str:
    """``nccl`` for a run on the card (the default), ``gloo`` on the CPU."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def launched_world(num_processes: int | None = None) -> int:
    """How many processes the launcher or the flags ask for (1 when run
    alone), before any group exists."""
    if num_processes is not None:
        return num_processes
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize_distributed(
    device: str | torch.device | None = None,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Join the group the flags or ``torchrun`` describe (nothing for a
    process started alone, or when this process has joined already);
    returns the world size."""
    if ddp.world() > 1 or torch.distributed.is_initialized():
        return ddp.world()
    backend = backend_for(device)
    if (num_processes or 1) > 1 or coordinator_address:
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError("--coordinator_address, --num_processes and --process_id "
                             "go together")
        ddp.init_distributed(backend, f"tcp://{coordinator_address}", num_processes,
                             process_id)
    elif "WORLD_SIZE" in os.environ:
        ddp.init_distributed(backend)
    else:
        return 1
    if backend == "nccl":
        resolve_device(device)  # NCCL's communicators form on the current card
    return ddp.world()
