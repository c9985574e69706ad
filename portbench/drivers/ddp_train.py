"""The ``ddp_train`` kind: the port's UDA train step data-parallel over the
cell's cards, one process a card, as ``torchrun tools/solve_gta5.py``
runs it.

Rank 0 is the benchmark's own process. First in its set-up it starts ranks
1 .. W-1 (spawned processes) on cards 1 .. W-1, so that their set-up
overlaps its own. Every rank makes the same weights from the seed and its
own pool of ``pool`` batch pairs from the seed's ``inputs<rank>`` stream,
joins the process group through ``parallel.ddp.init_distributed`` at a
TCP address on this host (NCCL on cards, gloo on the CPU), builds the step
object (``make_train_state`` wraps the model in DDP) and runs the
``checked_steps`` steps; rank 0 records them as the ``train`` kind does.

In the window rank 0 raises a shared counter before each unit, and the
other ranks run as many units as it says: every rank issues the same
steps, and rank 0's host waits on no other host beyond what the step's
collectives make it wait. In a traced run every rank runs its units under
``torch.profiler``, so that each pays the profiler's host cost and rank 0
is no slower than the others; only rank 0's trace is read. A rank that
fails ends the run: rank 0 watches the others' exit codes and, when one
ends before the run does, stops the rest and exits with an error; a rank
ends with rank 0's process; each collective times out after
``PG_TIMEOUT_S``.

The check runs on rank 0 once the others have ended: the plain reference's
steps over the global batch, every rank's share made again from the seed
and computed one share at a time with the global CE divisors
(``reference/uda.global_backward``). ``FAULT`` (a planted fault, for
``calibrate.py``): every rank steps on its own gradient under DDP's
``no_sync``, the gradient all-reduce left out.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import multiprocessing
from multiprocessing import resource_tracker
import os
import signal
import socket
import sys
import threading
import time

import torch
import torch.distributed as dist

from maxsquareloss_torch.parallel import ddp
from portbench import harness
from portbench.drivers import train

# the median leaf's change besides the worst leaf's: at the global batch the
# worst leaf's gap of sound runs overlaps what half of the batch left out reads
CHECKS = (*train.CHECKS, "change_gap_median")
FAULT = "no_sync"  # the planted fault: each rank steps on its own gradient
POLL_S = 2e-4  # how often an idle rank reads the counter
JOIN_S = 120.0  # how long rank 0 waits for the others to end after its window
PG_TIMEOUT_S = 180.0  # how long a collective waits for its peers


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Shared:
    """What rank 0 shares with the others: the units issued, whether its
    units run under the profiler, the end of the run, each rank's peak of
    device memory."""

    def __init__(self, ctx, world: int):
        self.target = ctx.RawValue("q", 0)
        self.profiled = ctx.RawValue("b", 0)
        self.stop = ctx.RawValue("b", 0)
        self.peaks = ctx.RawArray("q", world)


class Rank(train.Driver):
    """One rank's set-up and steps: ``train.Driver``'s, with the rank's own
    pool and the step over DDP."""

    def __init__(self, cell, seed: int, device, rank: int, init_method: str,
                 fault: str | None = None, phases: harness.Phases | None = None):
        self.rank, self.init_method, self.fault = rank, init_method, fault
        super().__init__(cell, seed, device, f"inputs{rank}", phases)

    def _join(self) -> None:
        ddp.init_distributed("nccl" if self.device.type == "cuda" else "gloo", self.init_method,
                             self.cell.chips, self.rank)
        # init_distributed takes no timeout; this sets the group's own
        dist.distributed_c10d._set_pg_timeout(datetime.timedelta(seconds=PG_TIMEOUT_S))
        self.phases.mark("group")

    def _make_step(self):
        return _with_fault(super()._make_step(), self.fault)


def _with_fault(step, fault: str | None):
    if fault is None:
        return step
    if fault != FAULT:
        raise ValueError(f"unknown fault {fault!r}")

    def own_gradient(state, *batch):
        with state.ddp_loss.no_sync():
            return step(state, *batch)

    return own_gradient


class Driver(Rank):
    """Rank 0: the other ranks' processes, the window's counter, the
    check."""

    def __init__(self, cell, seed: int, device, fault: str | None = None):
        phases = harness.Phases()
        self.seed = seed
        device = torch.device("cuda", 0) if device.type == "cuda" else device
        ctx = multiprocessing.get_context("spawn")
        self.shared = _Shared(ctx, cell.chips)
        init_method = f"tcp://localhost:{_free_port()}"
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(cell, seed, device.type, r, init_method, fault,
                                        self.shared, os.getpid()))
                      for r in range(1, cell.chips)]
        for p in self.procs:
            p.start()
        self._ending, self._closed = False, threading.Event()
        self._watch = threading.Thread(target=self._watch_ranks, daemon=True)
        self._watch.start()
        phases.mark("ranks")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        super().__init__(cell, seed, device, 0, init_method, fault, phases)

    def _watch_ranks(self) -> None:
        while not self._closed.wait(0.5):
            for r, p in enumerate(self.procs, 1):
                code = p.exitcode
                if code is not None and (code != 0 or not self._ending):
                    print(f"portbench: rank {r} ended with exit code {code} before the run "
                          "did; ending the run", file=sys.stderr, flush=True)
                    _end(self.procs)
                    os._exit(4)

    def unit(self, k: int) -> None:
        self.shared.profiled.value = int(torch.autograd.profiler._is_profiler_enabled)
        self.shared.target.value = k + 1
        super().unit(k)

    def release_program(self) -> None:
        """Free the program and end the other ranks after their last unit:
        leave the group with them (NCCL's teardown waits on its peers) and
        wait for them to end; raise if one fails. Once only."""
        if self._closed.is_set():
            return
        self._ending = True
        self.shared.stop.value = 1
        super().release_program()
        ddp.shutdown()
        deadline = time.monotonic() + JOIN_S
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        self._closed.set()
        self._watch.join()
        bad = {r: p.exitcode for r, p in enumerate(self.procs, 1) if p.exitcode != 0}
        if bad:
            _end(self.procs)
            raise RuntimeError(f"ranks that did not end cleanly (exit codes): {bad}")
        # the spawned ranks' resource tracker: ended and waited for here, not
        # left to end after this process
        with contextlib.suppress(AttributeError):
            resource_tracker._resource_tracker._stop()

    def e2e(self, units: int, seconds: float) -> dict:
        return {"train_images_per_s": units * self.images_per_step * self.cell.chips / seconds}

    def memory_peak_bytes(self) -> int:
        """The largest of every rank's peak (the others' at their end)."""
        self.release_program()
        own = (torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda"
               else 0)
        return max([own, *self.shared.peaks[1:]])

    def batches(self, half: bool = False):
        """The checked steps' global batches, every rank's share."""
        return global_batches(self.cell, self.seed, self.device, half)


def _end(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def global_batches(cell, seed: int, device, half: bool = False) -> list:
    """The checked steps' global batches, each a list of every rank's share
    (xs, ys, xt), made again from the seed; ``half``: the first half of
    each share (a planted fault)."""
    checked = cell.traffic["checked_steps"]
    shares = []
    for r in range(cell.chips):
        pool = train.make_pool(cell, seed, device, f"inputs{r}")
        shares.append([t[:checked].clone() for t in pool])
        del pool
    n = cell.traffic["batch"] // 2 if half else cell.traffic["batch"]
    return [[(xs[i, :n], ys[i, :n], xt[i, :n]) for xs, ys, xt in shares]
            for i in range(checked)]


def _die_with_parent(parent: int) -> None:
    """This process ends when rank 0's does (Linux's parent-death signal)."""
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def _worker(cell, seed: int, device_type: str, rank: int, init_method: str,
            fault: str | None, shared: _Shared, parent: int) -> None:
    """Rank ``rank`` (1 ..): set-up, then the units rank 0 issues, then its
    peak of device memory. Nothing of it goes to standard output."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    _die_with_parent(parent)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // cell.chips))
    harness.set_precision(cell.config)
    me = Rank(cell, seed, device, rank, init_method, fault)
    done, prof = 0, None
    while True:
        if done < shared.target.value:
            if shared.profiled.value and prof is None:
                prof = _profiler(device_type)
                prof.start()
            me.unit(done)
            done += 1
        elif shared.stop.value and done >= shared.target.value:
            break
        elif os.getppid() != parent:
            os._exit(1)
        else:
            time.sleep(POLL_S)
    harness.sync(device)
    if prof is not None:
        prof.stop()
        del prof
    shared.peaks[rank] = torch.cuda.max_memory_allocated(device) if device_type == "cuda" else 0
    ddp.shutdown()


def _profiler(device_type: str):
    """The profiler a traced run's window runs under (its trace unread)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_type == "cuda" else [])
    return profile(activities=acts)

