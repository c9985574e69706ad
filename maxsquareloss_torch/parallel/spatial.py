"""Spatial partitioning of the eval forward (``--sp``): the port's
counterpart of the ``'space'`` axis of ``maxsquareloss_tpu/parallel/mesh.py``.

The JAX package shards the image height over a mesh axis and GSPMD
inserts the halo exchanges. Here each rank is a process of its own and the
exchanges are explicit:

- **Groups.** The world is dp x sp ranks and a space group is ``sp``
  consecutive ranks (``devices.reshape(len // sp, sp)`` in JAX).
  ``space_group`` makes them: every rank creates every subgroup, in the same
  order; at ``sp == world`` the space group is the world group.
- **Ownership.** Every map of global height H splits the same way: rank
  ``s`` of its group owns rows ``[s*H//sp, (s+1)*H//sp)`` (``split``). A
  map's height comes from the global input height, never from a shard,
  so shards may be uneven or empty (a rank with no rows of a map launches
  nothing for it but still serves its neighbours' halos).
- **Windows.** An op that reads H with kernel k, stride s, padding p and
  dilation d computes its output rows ``[o0, o1)`` from input rows
  ``[o0*s - p, (o1-1)*s - p + (k-1)*d + 1)`` (``window``). ``fetch_rows``
  gathers the rows of such a window from whichever ranks own them,
  moving only those rows; ``fetch_window`` also pads with the op's pad
  value where the window passes the global border, so the op then runs with
  H padding 0 and its result is the one-process result's rows.

Transport: ``dist.batch_isend_irecv`` on the group's backend. NCCL takes
the card's tensors; gloo takes CPU tensors, so a CUDA tensor goes through
an explicit host copy (as ``parallel/ddp.py``'s collectives do), which is
how two ranks share one card and how the CPU tests run. An exchange that
fails raises: no path falls back to one process.

The exchange is written to be reversed: the backward of ``fetch_rows``
is the same plan with sends and receives swapped and the halo gradients
added to the owner's rows (not built yet; the trainers refuse ``--sp``).
A group's ``stats`` count the bytes this rank sent and received, the
exchanges and their wall seconds.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from maxsquareloss_torch.parallel import ddp

Rows = tuple[int, int]


def rows(h: int, sp: int, s: int) -> Rows:
    """The rows of a map of height ``h`` that rank ``s`` of ``sp`` owns."""
    return s * h // sp, (s + 1) * h // sp


def split(h: int, sp: int) -> list[Rows]:
    """Every rank's rows of a map of height ``h``, in rank order."""
    return [rows(h, sp, s) for s in range(sp)]


def window(own: Rows, k: int, s: int = 1, p: int = 0, d: int = 1) -> Rows:
    """The input rows an op (kernel ``k``, stride ``s``, padding ``p``,
    dilation ``d`` along H) reads for its output rows ``own``; it may pass
    the border (negative, or past the input's height). Empty for no rows."""
    o0, o1 = own
    if o1 <= o0:
        return (0, 0)
    return o0 * s - p, (o1 - 1) * s - p + (k - 1) * d + 1


def clip(r: Rows, h: int) -> Rows:
    """``r`` inside ``[0, h)`` (an empty range as (a, a))."""
    a, b = max(r[0], 0), min(r[1], h)
    return (a, a) if b <= a else (a, b)


def _overlap(a: Rows, b: Rows) -> Rows:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else (lo, lo)


@dataclasses.dataclass(frozen=True)
class SpaceGroup:
    """A rank's space group: ``sp`` ranks that split every map's rows.
    ``index``: this rank's place in it; ``ranks``: the group's global
    ranks in order; ``group``: its process group (None: the world's);
    ``stats``: this rank's exchanges since ``reset_stats``: bytes sent and
    received, exchanges with a send or a receive, and their wall seconds
    (over gloo the transfer's; over NCCL the host's, which does not wait
    for the card)."""

    sp: int
    index: int
    ranks: tuple[int, ...]
    group: object | None = None
    stats: dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats.update(bytes_sent=0, bytes_received=0, exchanges=0, seconds=0.0)

    def own(self, h: int) -> Rows:
        return rows(h, self.sp, self.index)

    def split(self, h: int) -> list[Rows]:
        return split(h, self.sp)

    def windows(self, h_out: int, k: int, s: int = 1, p: int = 0, d: int = 1) -> list[Rows]:
        """Every rank's input window of an op whose output map has
        ``h_out`` rows (``window`` of each rank's output rows)."""
        return [window(o, k, s, p, d) for o in self.split(h_out)]

    def backend(self) -> str:
        return dist.get_backend(self.group)


_groups: dict[int, SpaceGroup] = {}


def space_group(sp: int) -> SpaceGroup | None:
    """This rank's space group for ``--sp sp`` (None for 1): the world's
    ranks in consecutive blocks of ``sp``. The first call for an ``sp``
    creates every block's process group, in the same order on every rank
    (``dist.new_group`` is collective); later calls return it."""
    if sp <= 1:
        return None
    if sp in _groups:
        return _groups[sp]
    world, rank = ddp.world(), ddp.rank()
    if world % sp:
        raise ValueError(f"--sp {sp} does not divide the {world} process(es)")
    mine = None
    if sp == world:
        mine = SpaceGroup(sp, rank, tuple(range(world)))
    else:
        for g in range(world // sp):
            ranks = tuple(range(g * sp, (g + 1) * sp))
            pg = dist.new_group(list(ranks))
            if rank in ranks:
                mine = SpaceGroup(sp, rank - ranks[0], ranks, pg)
    # form the group's communicator with every rank in it (NCCL wants its
    # first call on a group to include all of the group's ranks)
    ddp.all_reduce_sum(torch.zeros(1), mine.group)
    _groups[sp] = mine
    return mine


def data_groups(sp: int) -> tuple[int, int]:
    """(this rank's data group, the number of data groups): the loader's
    ``shard_index`` and ``shard_count`` under ``--sp``; every rank of a
    space group loads the same images."""
    return ddp.rank() // max(sp, 1), ddp.world() // max(sp, 1)


def fetch_rows(x: torch.Tensor, own: list[Rows], need: list[Rows],
               space: SpaceGroup) -> torch.Tensor:
    """Rows ``need[index]`` of the global map, clipped to ``[0, H)``, as one
    contiguous tensor: ``x`` holds this rank's rows ``own[index]`` along
    dim 1 (an NHWC map, or (N, H, W) labels), ``own`` every rank's rows of
    the map, ``need`` every rank's request (H = ``own[-1][1]``). Collective
    over the space group: every rank calls it with the same ``own`` and
    ``need``, and sends each peer the rows of its own that the peer needs.
    Moves only those rows."""
    me, h = space.index, own[-1][1]
    if x.shape[1] != own[me][1] - own[me][0]:
        raise ValueError(f"fetch_rows: rank {me} holds {x.shape[1]} rows, owns {own[me]}")
    want = [clip(r, h) for r in need]
    gloo = space.backend() == "gloo"
    via_host = x.device.type == "cuda" and gloo
    comm = torch.device("cpu") if via_host else x.device

    def local(r: Rows) -> torch.Tensor:
        return x.narrow(1, r[0] - own[me][0], r[1] - r[0])

    ops, pieces, received = [], [], []
    for peer in range(space.sp):
        # what this rank receives from peer (in row order: peers own rows in
        # rank order), and what it sends peer
        got = _overlap(own[peer], want[me])
        if got[1] > got[0]:
            if peer == me:
                pieces.append(local(got))
            else:
                buf = torch.empty((x.shape[0], got[1] - got[0], *x.shape[2:]), dtype=x.dtype,
                                  device=comm)
                ops.append(dist.P2POp(dist.irecv, _wire(buf, gloo), space.ranks[peer],
                                      space.group))
                pieces.append(buf)
                received.append(buf)
        give = _overlap(own[me], want[peer])
        if peer != me and give[1] > give[0]:
            out = local(give).to(comm, copy=True).contiguous()
            ops.append(dist.P2POp(dist.isend, _wire(out, gloo), space.ranks[peer],
                                  space.group))
            space.stats["bytes_sent"] += out.numel() * out.element_size()
    if ops:
        t0 = time.perf_counter()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        space.stats["exchanges"] += 1
        space.stats["seconds"] += time.perf_counter() - t0
        space.stats["bytes_received"] += sum(b.numel() * b.element_size() for b in received)
    pieces = [p.to(x.device) for p in pieces]
    if not pieces:
        return x.new_empty((x.shape[0], 0, *x.shape[2:]))
    return torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0].contiguous()


def _wire(t: torch.Tensor, gloo: bool) -> torch.Tensor:
    """``t`` as the backend moves it: over gloo 2-byte floats as int16 (the
    same bytes); NCCL moves bfloat16 itself and has no int16."""
    return t.view(torch.int16) if gloo and t.dtype in (torch.bfloat16, torch.float16) else t


def fetch_window(x: torch.Tensor, h: int, need: list[Rows], space: SpaceGroup,
                 pad_value: float | None = 0.0) -> torch.Tensor:
    """``fetch_rows`` of a map of global height ``h`` split by ownership,
    then, with ``pad_value``, padded where this rank's window passes the
    border: the rows ``need[index]`` exactly, as the op's own padding would
    have made them. ``pad_value=None`` keeps the clipped rows."""
    got = fetch_rows(x, space.split(h), need, space)
    a, b = need[space.index]
    top, bottom = max(0, -a), max(0, b - max(a, h))
    if pad_value is None or b <= a or not (top or bottom):
        return got
    pad = (0, 0) * (got.dim() - 2) + (top, bottom)
    return F.pad(got, pad, value=pad_value)


def gather_rows(x: torch.Tensor, h: int, space: SpaceGroup, root: int = 0) -> torch.Tensor:
    """Every row of a map of height ``h`` on rank ``root`` of the group
    (the others get a map of no rows): ``fetch_rows`` with one request."""
    need = [(0, h) if s == root else (0, 0) for s in range(space.sp)]
    return fetch_rows(x, space.split(h), need, space)
