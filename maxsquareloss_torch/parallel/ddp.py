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
tensors, through a host copy, which is how two ranks share one card). The
collectives take a ``group`` (default: every rank), such as a space group
of ``parallel/spatial.py``; under ``--sp`` the data groups share a batch
(``local_batch(..., sp=...)``).

Training under ``--sp`` takes no DDP wrapper: its backward exchanges halo
gradients between the ranks of a space group, and DDP's bucket
all-reduces, fired from inside that backward, would interleave with them
in an order that differs between ranks. It starts from rank 0's
parameters (``broadcast_module``) and averages the gradients over the
world in one all-reduce after ``backward()`` (``average_gradients``).
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


def local_batch(global_batch: int, flag: str = "--batch_size", sp: int = 1) -> int:
    """This process's share of a global batch; raises when the processes
    cannot share it equally (the JAX package's check). Under ``--sp`` the
    ``world // sp`` data groups share it: every rank of a space group loads
    its group's share."""
    procs = world() // max(sp, 1)
    what = "processes" if sp <= 1 else f"data groups of --sp {sp}"
    if global_batch % procs:
        raise ValueError(f"global batch {global_batch} not divisible by {procs} {what}; "
                         f"raise {flag} to a multiple of {procs}")
    return global_batch // procs


def _comm_device(t: torch.Tensor, group=None) -> torch.device:
    """Where a collective over ``t`` runs: NCCL on the current card, gloo
    where ``t`` is."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _size(group) -> int:
    return world() if group is None else dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM of ``t`` over the ranks of ``group`` (default: all), on
    ``t``'s device (``t`` itself for one rank)."""
    if world() == 1 or _size(group) == 1:
        return t
    out = t.to(_comm_device(t, group), copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (of ``group``, default all) stacked along a new
    first axis, rank order (``t[None]`` for one rank)."""
    if world() == 1 or _size(group) == 1:
        return t[None]
    src = t.to(_comm_device(t, group))
    parts = [torch.empty_like(src) for _ in range(_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.stack(parts).to(t.device)


def _flat_collective(tensors: list[torch.Tensor], fn) -> None:
    """``fn(flat)`` on one flat copy of ``tensors`` (one dtype) on the
    collective's device, copied back into them in place."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).to(_comm_device(tensors[0]))
    fn(flat)
    flat = flat.to(tensors[0].device)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and persistent buffer of ``module`` from rank
    ``src`` (a broadcast a dtype), as DDP's wrapper does at its start."""
    if world() == 1:
        return
    tensors = [*module.parameters(), *module.state_dict().values()]
    seen, by_dtype = set(), {}
    for t in tensors:
        if t.data_ptr() not in seen and t.is_floating_point():
            seen.add(t.data_ptr())
            by_dtype.setdefault(t.dtype, []).append(t.data)
    for group in by_dtype.values():
        _flat_collective(group, lambda flat: dist.broadcast(flat, src))


@torch.no_grad()
def average_gradients(params: list[torch.Tensor]) -> None:
    """Each gradient replaced by its mean over the world's ranks, in one
    all-reduce (the mean DDP takes); a parameter without one takes zeros,
    so every rank's buffer has every parameter."""
    if world() == 1:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(world())

    _flat_collective(grads, mean)


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
