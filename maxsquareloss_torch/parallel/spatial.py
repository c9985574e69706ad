"""Spatial partitioning (``--sp``): the port's counterpart of the
``'space'`` axis of ``maxsquareloss_tpu/parallel/mesh.py``, for the eval
forward and for training.

The JAX package shards the image height over a mesh axis and GSPMD
inserts the halo exchanges. Here each rank is a process of its own and the
exchanges are explicit:

- **Groups.** The world is dp x sp ranks and a space group is ``sp``
  consecutive ranks (``devices.reshape(len // sp, sp)`` in JAX).
  ``space_group`` makes them: every rank creates every subgroup, in the same
  order, each a process group of its own (at ``sp == world`` too), so the
  exchanges never share a communicator with the world's collectives.
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

**The backward** (training). Under grad a fetch that moves rows is an
``autograd.Function`` whose backward runs the same plan reversed: each
rank sends back the gradient of the rows it fetched from a peer, and the
owner adds the halo gradients to the gradient of its own rows, every
contribution in rank order (deterministic, whatever the requests'
overlaps). Padding past the border gets no gradient (``F.pad``'s
adjoint), and the -inf of the ceil-mode pool never wins a max against a
real row. The exchanges of a backward must pair up on every rank in the
same order, while autograd orders ready nodes by what each rank's graph
holds: so every such fetch also takes and returns a 0-d *token*, chained
from one fetch to the next in forward order and joined to the loss
(``join``); the backward then runs the exchanges in exactly the reverse
order on every rank, and runs each on a rank whose own rows of the map
reach no loss. A training forward under ``--sp`` runs inside
``training(space)``. A map that a rank owns no rows of is an empty tensor
tied to the op's inputs and parameters (``no_rows``), so its
``requires_grad`` is every rank's and each parameter gets a gradient
(zero) on every rank.

**Stage remat** (``--remat stages``): a checkpointed stage's recompute
re-runs its forward inside the backward, in each rank's own autograd order
and outside the token chain, so it must not exchange again. Its first
forward keeps the rows each fetch received from peers (``RowLog``, a few
rows a side), and the recompute (``remat_region``) reads them back in call
order with no exchange, neither reading nor advancing the chain's token:
the first forward's fetches stay in the graph, and the backward's exchanges
are theirs.

**The serving export** (``tools/export_inference.py --sp``): ``torch.export``
cannot trace ``dist`` calls, so an exchange without grad is the custom op
``msl::sp_fetch_rows`` (its arguments: the map, a 0-d token, every rank's
rows and request as flat integer lists, and the key of the space group in
this module's registry, which the loading process fills by joining a group
of the same ``sp``), and ``all_rows`` (the whole map on every rank) is
``msl::sp_all_rows``. Inside ``serving(space)`` each op takes the token the
previous one returned and ``all_rows`` takes the last: the exported graph's
output depends on every exchange, so none is dropped as dead code (a rank
that only gives rows, or owns none of a map, still joins), none is merged
with another, and every rank runs them in one order.

A group's ``stats`` count the bytes this rank sent and received, the
exchanges and their wall seconds, forward and (``backward_*``) backward.
"""

from __future__ import annotations

import contextlib
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


_STATS = ("bytes_sent", "bytes_received", "exchanges", "seconds")


@dataclasses.dataclass(frozen=True)
class SpaceGroup:
    """A rank's space group: ``sp`` ranks that split every map's rows.
    ``index``: this rank's place in it; ``ranks``: the group's global
    ranks in order; ``group``: its process group; ``stats``: this rank's
    exchanges since ``reset_stats``: bytes sent and received, exchanges
    with a send or a receive, and their wall seconds (over gloo the
    transfer's; over NCCL the host's, which does not wait for the card),
    forward and, as ``backward_<key>``, backward; ``chain``: the token
    chain of the training forward in flight (``training``)."""

    sp: int
    index: int
    ranks: tuple[int, ...]
    group: object | None = None
    stats: dict = dataclasses.field(default_factory=dict, compare=False)
    chain: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats.update({k: 0 for k in _STATS}, seconds=0.0)
        self.stats.update({f"backward_{k}": 0 for k in _STATS}, backward_seconds=0.0)

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


# every space group of this process by its sp: the key the exchange ops name
_groups: dict[int, SpaceGroup] = {}


def space_group(sp: int) -> SpaceGroup | None:
    """This rank's space group for ``--sp sp`` (None for 1): the world's
    ranks in consecutive blocks of ``sp``, each block a process group of its
    own. The first call for an ``sp`` creates every block's group, in the
    same order on every rank (``dist.new_group`` is collective); later calls
    return it."""
    if sp <= 1:
        return None
    if sp in _groups:
        return _groups[sp]
    world, rank = ddp.world(), ddp.rank()
    if world % sp:
        raise ValueError(f"--sp {sp} does not divide the {world} process(es)")
    mine = None
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


def _p2p(space: SpaceGroup, like: torch.Tensor, sends: dict, recvs: dict,
         backward: bool) -> dict:
    """One exchange: ``sends[peer]`` goes to each peer, a tensor of shape
    ``recvs[peer]`` (``like``'s dtype) comes from each; returns the received
    tensors on ``like``'s device, by peer."""
    gloo = space.backend() == "gloo"
    comm = torch.device("cpu") if like.device.type == "cuda" and gloo else like.device
    stats, pre = space.stats, "backward_" if backward else ""
    ops, got = [], {}
    for peer in range(space.sp):
        if peer in recvs:
            got[peer] = torch.empty(recvs[peer], dtype=like.dtype, device=comm)
            ops.append(dist.P2POp(dist.irecv, _wire(got[peer], gloo), space.ranks[peer],
                                  space.group))
        if peer in sends:
            out = sends[peer].to(comm, copy=True).contiguous()
            ops.append(dist.P2POp(dist.isend, _wire(out, gloo), space.ranks[peer],
                                  space.group))
            stats[pre + "bytes_sent"] += out.numel() * out.element_size()
    if ops:
        t0 = time.perf_counter()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        stats[pre + "exchanges"] += 1
        stats[pre + "seconds"] += time.perf_counter() - t0
        stats[pre + "bytes_received"] += sum(b.numel() * b.element_size() for b in got.values())
    return {peer: b.to(like.device) for peer, b in got.items()}


def _wire(t: torch.Tensor, gloo: bool) -> torch.Tensor:
    """``t`` as the backend moves it: over gloo 2-byte floats as int16 (the
    same bytes); NCCL moves bfloat16 itself and has no int16."""
    return t.view(torch.int16) if gloo and t.dtype in (torch.bfloat16, torch.float16) else t


def _rows_of(t: torch.Tensor, r: Rows, first: int) -> torch.Tensor:
    """Rows ``r`` of a map of which ``t`` holds rows from ``first`` on."""
    return t.narrow(1, r[0] - first, r[1] - r[0])


def _plan(own: list[Rows], want: list[Rows], me: int) -> tuple[dict, dict]:
    """(the rows of its window that each peer owns, the rows of its own that
    each peer wants), by peer in rank order, empty overlaps left out."""
    gets = {p: _overlap(o, want[me]) for p, o in enumerate(own)}
    gives = {p: _overlap(own[me], w) for p, w in enumerate(want)}
    return ({p: r for p, r in gets.items() if r[1] > r[0]},
            {p: r for p, r in gives.items() if r[1] > r[0]})


def _shape(t: torch.Tensor, r: Rows) -> tuple:
    return (t.shape[0], r[1] - r[0], *t.shape[2:])


def _fetch(x: torch.Tensor, own: list[Rows], want: list[Rows], space: SpaceGroup,
           got: dict | None = None) -> torch.Tensor:
    """This rank's window ``want[index]`` of a map of which ``x`` holds rows
    ``own[index]``, as a new contiguous tensor (never a view of ``x``). The
    peers' rows come from the exchange, or from ``got`` (a recompute's
    replay, which exchanges nothing); a ``remat_region`` recording keeps
    them."""
    me = space.index
    gets, gives = _plan(own, want, me)
    if got is None:
        got = _p2p(space, x, {p: _rows_of(x, r, own[me][0]) for p, r in gives.items() if p != me},
                   {p: _shape(x, r) for p, r in gets.items() if p != me}, backward=False)
        log = space.chain.get("rows_log")
        if log is not None:
            log.entries.append(got)
    # in row order: peers own rows in rank order
    pieces = [_rows_of(x, r, own[me][0]) if p == me else got[p] for p, r in gets.items()]
    if not pieces:
        return x.new_empty((x.shape[0], 0, *x.shape[2:]))
    if len(pieces) > 1:
        return torch.cat(pieces, dim=1)
    return pieces[0].clone(memory_format=torch.contiguous_format)


def _fetch_backward(g: torch.Tensor, x_rows: int, own: list[Rows], want: list[Rows],
                    space: SpaceGroup) -> torch.Tensor:
    """The adjoint of ``_fetch``: the gradient of this rank's ``x_rows``
    rows from the gradient ``g`` of its fetched rows, each peer's halo
    gradient added to the rows it fetched, in rank order."""
    me = space.index
    gets, gives = _plan(own, want, me)
    got = _p2p(space, g, {p: _rows_of(g, r, want[me][0]) for p, r in gets.items() if p != me},
               {p: _shape(g, r) for p, r in gives.items() if p != me}, backward=True)
    dx = g.new_zeros((g.shape[0], x_rows, *g.shape[2:]))
    for p, r in gives.items():
        _rows_of(dx, r, own[me][0]).add_(_rows_of(g, r, want[me][0]) if p == me else got[p])
    return dx


class _FetchRows(torch.autograd.Function):
    """``_fetch`` with its adjoint; ``token`` in, the next token out (the
    order of the backward's exchanges, module docstring)."""

    @staticmethod
    def forward(ctx, x, token, own, want, space):
        ctx.plan = (x.shape[1], own, want, space)
        return _fetch(x, own, want, space), token.new_zeros(())

    @staticmethod
    def backward(ctx, g, g_token):
        x_rows, own, want, space = ctx.plan
        return _fetch_backward(g.contiguous(), x_rows, own, want, space), g_token, None, None, None


class _Join(torch.autograd.Function):
    """``loss`` itself, with the token chain behind it."""

    @staticmethod
    def forward(ctx, loss, token):
        return loss.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=g.dtype, device=g.device)


@contextlib.contextmanager
def training(space: SpaceGroup | None):
    """The scope of one training forward and backward under ``space`` (a
    no-op for None): its fetches chain their tokens, and ``join`` ties the
    chain to the loss."""
    if space is None:
        yield
        return
    space.chain.clear()
    space.chain["open"] = True
    try:
        yield
    finally:
        space.chain.clear()


def join(loss: torch.Tensor, space: SpaceGroup | None) -> torch.Tensor:
    """``loss`` with this forward's token chain joined to it, so that its
    backward runs every exchange of the forward in reverse order."""
    token = None if space is None else space.chain.get("token")
    return loss if token is None else _Join.apply(loss, token)


def _flat(rs: list[Rows]) -> list[int]:
    return [v for r in rs for v in r]


def _pairs(flat: list[int]) -> list[Rows]:
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def _registered(group: int) -> SpaceGroup:
    if group not in _groups:
        raise RuntimeError(f"no space group of sp {group} in this process: join one with "
                           f"spatial.space_group({group}) (a torchrun group of {group} ranks) "
                           "before running a graph that exchanges rows")
    return _groups[group]


@torch.library.custom_op("msl::sp_fetch_rows", mutates_args=(), schema=(
    "(Tensor x, Tensor token, int[] own, int[] want, int group) -> (Tensor, Tensor)"))
def _fetch_op(x, token, own, want, group):
    """``_fetch`` as an op: (the window, the next token)."""
    return _fetch(x, _pairs(own), _pairs(want), _registered(group)), token.new_zeros(())


@_fetch_op.register_fake
def _fetch_op_fake(x, token, own, want, group):
    a, b = _pairs(want)[_registered(group).index]
    return x.new_empty((x.shape[0], b - a, *x.shape[2:])), token.new_empty(())


@torch.library.custom_op("msl::sp_all_rows", mutates_args=(), schema=(
    "(Tensor x, Tensor token, int[] own, int group) -> Tensor"))
def _all_rows_op(x, token, own, group):
    """Every row of the map on every rank, after the exchange ``token``
    ends."""
    own, space = _pairs(own), _registered(group)
    return _fetch(x, own, [(0, own[-1][1])] * space.sp, space)


@_all_rows_op.register_fake
def _all_rows_op_fake(x, token, own, group):
    return x.new_empty((x.shape[0], own[-1], *x.shape[2:]))


def _serving_token(space: SpaceGroup, like: torch.Tensor) -> torch.Tensor:
    token = space.chain.get("serve_token") if space.chain.get("serving") else None
    return like.new_zeros((), dtype=torch.int32) if token is None else token


@contextlib.contextmanager
def serving(space: SpaceGroup | None):
    """The scope of one exported forward under ``space`` (a no-op for
    None): its exchanges chain their tokens and ``all_rows`` ends the chain
    (module docstring)."""
    if space is None:
        yield
        return
    space.chain.update(serving=True, serve_token=None)
    try:
        yield
    finally:
        space.chain.pop("serving", None)
        space.chain.pop("serve_token", None)


def all_rows(x: torch.Tensor, h: int, space: SpaceGroup) -> torch.Tensor:
    """Every row of a map of height ``h`` split by ownership, on every rank
    of the group (``x``: this rank's rows; no grad). Collective."""
    token = _serving_token(space, x)
    return _all_rows_op(x, token, _flat(space.split(h)), space.sp)


class RowLog:
    """The rows that the fetches of one checkpointed region received from
    peers in its first forward, in call order (``remat_region``)."""

    def __init__(self):
        self.entries: list[dict] = []
        self.recorded = False


@contextlib.contextmanager
def remat_region(space: SpaceGroup | None, log: RowLog):
    """One run of a checkpointed region under ``space``: the first records
    into ``log`` the rows each fetch receives; a later one (the recompute
    in the backward) replays them in the same order and exchanges nothing
    (module docstring)."""
    if space is None:
        yield
        return
    prev = space.chain.get("rows_log"), space.chain.get("replay")
    replay = iter(log.entries) if log.recorded else None
    space.chain["rows_log"], space.chain["replay"] = (None, replay) if log.recorded else (log, None)
    try:
        yield
    finally:
        log.recorded = True
        space.chain["rows_log"], space.chain["replay"] = prev


def fetch_rows(x: torch.Tensor, own: list[Rows], need: list[Rows],
               space: SpaceGroup) -> torch.Tensor:
    """Rows ``need[index]`` of the global map, clipped to ``[0, H)``, as one
    contiguous tensor: ``x`` holds this rank's rows ``own[index]`` along
    dim 1 (an NHWC map, or (N, H, W) labels), ``own`` every rank's rows of
    the map, ``need`` every rank's request (H = ``own[-1][1]``). Collective
    over the space group: every rank calls it with the same ``own`` and
    ``need``, and sends each peer the rows of its own that the peer needs.
    Moves only those rows. Differentiable in ``x`` (module docstring)."""
    me, h = space.index, own[-1][1]
    if x.shape[1] != own[me][1] - own[me][0]:
        raise ValueError(f"fetch_rows: rank {me} holds {x.shape[1]} rows, owns {own[me]}")
    want = [clip(r, h) for r in need]
    moves = any(p != q for q in range(space.sp) for p in _plan(own, want, q)[0])
    if not moves:  # every window inside its own rows, on every rank: a slice
        a, b = _overlap(own[me], want[me])
        return x.narrow(1, a - own[me][0], b - a) if b > a else x[:, :0]
    replay = space.chain.get("replay")
    if replay is not None:  # a recompute: the first forward's rows, no exchange
        return _fetch(x, own, want, space, got=next(replay))
    if not (torch.is_grad_enabled() and x.requires_grad):
        out, token = _fetch_op(x, _serving_token(space, x), _flat(own), _flat(want), space.sp)
        if space.chain.get("serving"):
            space.chain["serve_token"] = token
        return out
    if not space.chain.get("open"):
        raise RuntimeError("a forward with grad under --sp runs inside spatial.training(space), "
                           "whose loss goes through spatial.join (train/steps.py)")
    token = space.chain.get("token")
    if token is None:
        token = torch.zeros((), device=x.device, requires_grad=True)
    out, space.chain["token"] = _FetchRows.apply(x, token, own, want, space)
    return out


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


class _NoRows(torch.autograd.Function):
    """An empty map that depends on ``tensors``: their gradient through it
    is zero."""

    @staticmethod
    def forward(ctx, empty, *tensors):
        ctx.specs = [(t.shape, t.dtype, t.device) for t in tensors]
        return empty.clone(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        return None, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.specs)


def no_rows(shape: tuple, like: torch.Tensor, *inputs: torch.Tensor | None) -> torch.Tensor:
    """The output of a rank that owns no rows of a map: an empty
    channels_last NCHW map of ``shape`` (H 0) in ``like``'s dtype, which
    under grad depends on ``inputs`` (the op's input map and parameters), so
    it requires grad where the other ranks' rows do and each parameter gets
    a zero gradient here."""
    empty = like.new_empty(shape).contiguous(memory_format=torch.channels_last)
    tied = [t for t in inputs if t is not None and t.requires_grad]
    if not (torch.is_grad_enabled() and tied):
        return empty
    return _NoRows.apply(empty, *tied)
