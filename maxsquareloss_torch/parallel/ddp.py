"""One process per card (the port's counterpart of
``maxsquareloss_tpu/parallel/mesh.py``).

The JAX package shards the global batch over a mesh of every local device
inside one process; XLA inserts the gradient all-reduce. Here each card
has a process of its own, ``torchrun`` starts them, and
``DistributedDataParallel`` averages the gradients. Batch sizes stay
global: each process loads ``global // world`` images of every batch
(``local_batch``), the shard of ``SegDataLoader`` that the JAX package's
processes load.

With no process group (one process), ``rank()`` is 0, ``world()`` 1 and
every collective below is the identity, so a one-process run is the run of
a port without this module. Each collective runs on the group's backend:
``nccl`` takes tensors on the card, ``gloo`` takes CPU tensors (and CUDA
tensors, through a host copy, which is how two ranks share one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def init_distributed(backend: str, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None) -> None:
    """Join the process group. By default from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); else at
    ``init_method`` (``tcp://host:port`` or ``file://path``) as ``rank`` of
    ``world_size``. ``backend``: ``nccl`` on the card, ``gloo`` for CPU
    tensors and for several ranks on one card."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if init_method is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_batch(global_batch: int, flag: str = "--batch_size") -> int:
    """This process's share of a global batch; raises when the processes
    cannot share it equally (the JAX package's check)."""
    procs = world()
    if global_batch % procs:
        raise ValueError(f"global batch {global_batch} not divisible by {procs} processes; "
                         f"raise {flag} to a multiple of {procs}")
    return global_batch // procs


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective over ``t`` runs: NCCL on the current card, gloo
    where ``t`` is."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The SUM of ``t`` over the ranks, on ``t``'s device (``t`` itself at
    world 1)."""
    if world() == 1:
        return t
    out = t.to(_comm_device(t), copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out.to(t.device)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new first axis, rank order
    (``t[None]`` at world 1)."""
    if world() == 1:
        return t[None]
    src = t.to(_comm_device(t))
    parts = [torch.empty_like(src) for _ in range(world())]
    dist.all_gather(parts, src.contiguous())
    return torch.stack(parts).to(t.device)


def any_flag(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (a MAX); a host
    sync."""
    if world() == 1:
        return bool(flag)
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (the end of a CLI run under ``torchrun``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def wrap(module: torch.nn.Module) -> torch.nn.parallel.DistributedDataParallel:
    """``module`` under DDP. The gradients live in DDP's buckets from the
    start (``gradient_as_bucket_view`` over gradients made here in each
    parameter's layout), so backward accumulates into them in place: no
    copy into the buckets and no strides to disagree with them.
    ``broadcast_buffers=False``: every buffer of the model (frozen BN, the
    packed eval weights) is a function of replicated parameters or of the
    same file on every rank."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.grad = torch.zeros_like(p)
    dev = params[0].device
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False, gradient_as_bucket_view=True)
