"""The ranks of a domain decomposition: one process per rank, one
``torch.distributed`` process group, and the few collectives the slabs use.

:func:`launch` runs ``fn(group, *args)`` on ``world`` ranks.  Rank 0 is the
calling process, so a caller's callbacks (a save, a gauge) run where they
were made and its result comes back as a value; ranks 1.. are started by
``torch.multiprocessing`` with the spawn method and receive ``args`` through
a file in a temporary directory, loaded onto their own device
(``torch.load(map_location=...)``), so a state made on the card reaches them
without CUDA IPC.  The rendezvous goes through a ``file://`` store in the
same directory: no port is opened.

* **Devices.**  Rank r runs on ``cuda:(r % torch.cuda.device_count())``,
  or on the CPU when the caller asks for it.
* **Backend.**  NCCL when every rank has a card of its own, gloo on the
  CPU.  With more ranks than cards NCCL cannot run (it refuses two ranks
  on one device): the caller must then pass ``backend="gloo"``, else
  :func:`launch` raises ValueError.  No backend is ever chosen because
  another failed.
* **Shared card.**  Under gloo the collectives take the ranks' CUDA
  tensors as they are; gloo moves them through host memory inside each
  collective, so its copies show in a profiler's trace of the card.
  :attr:`Group.counts` counts the collectives and the bytes a rank puts
  into them.
* **Failures.**  The process group has a timeout, a rank that raises fails
  the run (its traceback is re-raised in the caller), and the ranks are
  joined within a time limit, past which they are killed.

The collectives have static sizes, as the JAX package's ``ppermute`` /
``pmax`` / ``psum`` have: :meth:`Group.exchange` sends ``cap`` rows to each
x-neighbour through one ``all_to_all_single`` with split sizes (0 to every
other rank), :meth:`Group.all_reduce` reduces one stacked tensor, and
:meth:`Group.gather` brings equal-sized blocks to rank 0.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT = 120.0     # seconds: the process group's and the ranks' start


@dataclass
class Group:
    """One rank's view of the decomposition's process group."""
    rank: int
    world: int
    device: torch.device
    backend: str
    # since the last reset: collectives launched and the bytes this rank
    # put into them
    counts: dict = field(default_factory=lambda: dict(collectives=0,
                                                      bytes=0))

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    def _out(self, t):
        """``t``, counted as one collective's input."""
        self.counts["collectives"] += 1
        self.counts["bytes"] += t.numel() * t.element_size()
        return t

    # -- collectives ---------------------------------------------------------

    def exchange(self, to_left, to_right):
        """(from_left, from_right): rows from the x-neighbours.  ``to_left``
        / ``to_right`` are (cap, k) tensors of one dtype and shape, or None
        where this rank has no neighbour on that side; what comes back from
        a side without a neighbour is None.  One ``all_to_all_single``:
        ``cap`` rows to rank-1 and rank+1, 0 to the others."""
        like = to_left if to_left is not None else to_right
        if like is None:
            return None, None
        cap = like.shape[0]
        left, right = self.rank > 0, self.rank < self.world - 1
        send = [t for t, ok in ((to_left, left), (to_right, right)) if ok]
        splits = [cap if abs(j - self.rank) == 1 else 0
                  for j in range(self.world)]
        inp = self._out(torch.cat(send) if len(send) > 1 else send[0])
        out = torch.empty((cap * len(send),) + tuple(like.shape[1:]),
                          dtype=like.dtype, device=inp.device)
        dist.all_to_all_single(out, inp.contiguous(), splits, splits)
        from_left = out[:cap] if left else None
        from_right = out[-cap:] if right else None
        return from_left, from_right

    def all_reduce(self, t, op: str = "max"):
        """``t`` reduced over the ranks (``op`` "max" or "sum"), the same
        on every rank."""
        x = self._out(t.clone())
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return x

    def gather(self, t):
        """Rank 0: the list of every rank's ``t`` (equal shapes), on this
        rank's device; other ranks: None."""
        x = self._out(t.contiguous())
        bufs = ([torch.empty_like(x) for _ in range(self.world)]
                if self.rank == 0 else None)
        dist.gather(x, bufs, dst=0)
        return bufs

    def broadcast(self, t):
        """Rank 0's ``t`` on every rank."""
        x = self._out(t.clone())
        dist.broadcast(x, src=0)
        return x


def plan(world: int, device="cuda", backend: str | None = None):
    """(devices, backend) of ``world`` ranks on ``device`` ("cuda"
    or "cpu"): the rule in the module's docstring.  Raises ValueError for a
    backend the ranks cannot run."""
    if world < 1:
        raise ValueError(f"a decomposition needs at least one rank, not "
                         f"{world}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"ranks on the CPU run gloo, not {backend}")
        return [torch.device("cpu")] * world, "gloo"
    ncard = torch.cuda.device_count()
    if ncard < 1:
        raise ValueError("no CUDA device: pass device='cpu' to run the "
                         "ranks on the CPU")
    devices = [torch.device("cuda", r % ncard) for r in range(world)]
    if backend is None:
        if world > ncard:
            raise ValueError(
                f"{world} ranks on {ncard} card(s): NCCL cannot run two "
                f"ranks on one device; pass backend='gloo' to share the "
                f"card(s)")
        backend = "nccl"
    if backend == "nccl" and world > ncard:
        raise ValueError(f"{world} ranks on {ncard} card(s): NCCL cannot "
                         f"run two ranks on one device")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    return devices, backend


def _init(rank, world, store, backend, device, timeout):
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))


def _child(i, fn, world, store, payload, backend, devices, timeout,
           threads):
    """A spawned rank (i + 1): join the group, load the arguments onto its
    device, run ``fn``."""
    rank = i + 1
    device = devices[rank]
    torch.set_num_threads(threads)
    _init(rank, world, store, backend, device, timeout)
    try:
        args = torch.load(payload, map_location=device, weights_only=False)
        fn(Group(rank, world, device, backend), *args)
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, args=(), *, device="cuda", backend=None,
           timeout: float = TIMEOUT, limit: float | None = None,
           log=print, local=None):
    """Run ``fn(group, *args)`` on ``world`` ranks (rank 0 here, the others
    spawned) and return rank 0's result.  ``fn`` must be importable (a
    module-level function) and ``args`` picklable by ``torch.save``;
    ``local``: keyword arguments for rank 0 alone (callbacks that stay in
    this process).
    ``timeout``: the process group's, in seconds, and the spawned ranks'
    to exit after rank 0's return; ``limit``: the whole run's, past which
    a watchdog kills the spawned ranks (rank 0's next collective then
    fails) and TimeoutError is raised.  The spawned ranks take this
    process's ``torch.get_num_threads()``."""
    devices, backend = plan(world, device, backend)
    threads = torch.get_num_threads()
    log(f"[shard] {world} rank(s) on "
        f"{', '.join(str(d) for d in devices)}, backend {backend}")
    tmp = tempfile.mkdtemp(prefix="dsph_shard_")
    store = os.path.join(tmp, "rendezvous")
    payload = os.path.join(tmp, "args.pt")
    ctx = watchdog = None
    expired = threading.Event()
    try:
        if world > 1:
            torch.save(tuple(args), payload)
            import torch.multiprocessing as mp
            ctx = mp.start_processes(
                _child, args=(fn, world, store, payload, backend, devices,
                              timeout, threads),
                nprocs=world - 1, join=False, start_method="spawn")
            if limit is not None:
                watchdog = threading.Timer(limit, _expire, (ctx, expired))
                watchdog.daemon = True
                watchdog.start()
        try:
            _init(0, world, store, backend, devices[0], timeout)
            try:
                out = fn(Group(0, world, devices[0], backend), *args,
                         **(local or {}))
            finally:
                dist.destroy_process_group()
        except BaseException as e:
            if expired.is_set():
                raise TimeoutError(f"the ranks outlived the run's limit of "
                                   f"{limit:g} s") from e
            _surface(ctx)
            raise
        deadline = time.monotonic() + timeout
        while ctx is not None and not ctx.join(timeout=1.0):
            if expired.is_set() or time.monotonic() > deadline:
                raise TimeoutError("the spawned ranks did not exit after "
                                   "rank 0's return")
        return out
    finally:
        if watchdog is not None:
            watchdog.cancel()
        if ctx is not None:
            _kill(ctx)
        shutil.rmtree(tmp, ignore_errors=True)


def _kill(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join(5.0)


def _expire(ctx, expired):
    """The watchdog: the run outlived its limit."""
    expired.set()
    _kill(ctx)


def _surface(ctx):
    """Re-raise a spawned rank's failure, if one failed, in place of rank
    0's (a rank that dies leaves rank 0's collective to fail)."""
    if ctx is None:
        return
    try:
        ctx.join(timeout=5.0)
    except Exception as e:      # the child's exception, with its traceback
        raise RuntimeError(f"a rank failed: {e}") from e
