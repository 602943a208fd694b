"""One run of a cell over n cards: one process a card, as the program's
parallel layer runs (``batchelor_torch/parallel/mesh.py``).

The benchmark's own process is rank 0. For a cell whose ``chips`` n is
above 1 it starts ranks 1 .. n - 1 as its children: the same script with
the hidden arguments ``--rank r --world n --port p --root R --device K
--parent P``. Rank r computes on ``cuda:r`` (``LOCAL_RANK=r``, which
``make_cells_mesh`` reads), or on the CPU where rank 0 does, and runs on
cores of its own (``cores``). Every rank joins two groups over the same
ranks: the program's world, through the program's
``initialize_multihost("127.0.0.1:p", n, r)`` (NCCL between cards, gloo on
the CPU), and a gloo group of the harness's own, which carries everything
the harness says between ranks: that the inputs agree, each call's order
and its closing barrier, each rank's count of calls, its peak memory and
its traced busy time, and, while the reference judges, rank 0's pairs and
each rank's share of the reference's searches. The program's group
carries nothing of the harness's.

A worker dies with rank 0 (``PR_SET_PDEATHSIG``), and rank 0 kills and
reaps every worker that has not exited when it closes or fails. A worker
that dies leaves rank 0 failing in its next collective: at once on gloo,
or at the groups' timeout (``TIMEOUT_S``) where NCCL waits on it.
"""
from __future__ import annotations

import argparse
import ctypes
import datetime
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence

__all__ = ["TIMEOUT_S", "CALL", "STOP", "World", "cores", "checksum", "die_with_parent",
           "add_worker_args"]

TIMEOUT_S = 240
CALL, STOP = 1, 0                   # rank 0's orders: call once more, stop
_EXIT_WAIT_S = 60


def cores(rank: int, world: int, allowed: Sequence[int]) -> List[int]:
    """Rank ``rank``'s cores: positions [-2(r+1), -2r) of the sorted
    ``allowed`` set, so rank 0 keeps the last two; one core each for the
    other ranks where fewer than 2 x ``world`` are allowed."""
    allowed = sorted(allowed)
    n = len(allowed)
    if rank == 0 or n >= 2 * world:
        return allowed[max(0, n - 2 * (rank + 1)):n - 2 * rank]
    return [allowed[(n - 2 - rank) % n]]


def add_worker_args(ap: argparse.ArgumentParser) -> None:
    """The hidden arguments with which rank 0 starts a worker."""
    for hidden, kind in (("--rank", int), ("--world", int), ("--port", int), ("--root", str),
                         ("--device", str), ("--parent", int)):
        ap.add_argument(hidden, type=kind, default=None, help=argparse.SUPPRESS)


def die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent exits, and exit
    now if the parent ``parent`` has already gone."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, int(signal.SIGKILL))          # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(3)


def checksum(batches) -> list:
    """Each batch's shape and integer sums of its bytes, plain and weighted
    by position: exact, so they agree across devices whatever order the
    sums take."""
    import torch

    out = []
    for b in batches:
        flat = b.detach().contiguous().view(-1).view(torch.uint8)
        plain = weighted = 0
        step = 1 << 26
        for lo in range(0, flat.numel(), step):
            part = flat[lo:lo + step].to(torch.int64)
            pos = torch.arange(lo, lo + part.numel(), device=part.device) % 251 + 1
            plain += int(part.sum())
            weighted += int((part * pos).sum())
        out.append([list(b.shape), str(b.dtype), plain, weighted])
    return out


class World:
    """This process's place in one run of a cell: its ``rank`` of ``size``,
    the port of rank 0's rendezvous, and, on rank 0, its workers. A world
    of one has no groups, and every exchange is the identity."""

    def __init__(self, rank: int = 0, size: int = 1, port: int = 0,
                 workers: Sequence[subprocess.Popen] = ()):
        self.rank, self.size, self.port = rank, size, port
        self.workers = list(workers)
        self.group = None
        self.dev = None             # a worker's device (``of_worker``)

    @classmethod
    def start(cls, script: Path, argv: Sequence[str], size: int, root: Path,
              device_kind: str) -> "World":
        """Rank 0 of ``size`` ranks: starts ranks 1 .. size - 1 as
        ``python script *argv`` with the hidden arguments added (a world of
        one starts none). Their standard output goes to this process's
        standard error, so that the last line of standard output stays
        rank 0's."""
        if size == 1:
            return cls()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        world = cls(0, size, port)
        try:
            for r in range(1, size):
                cmd = [sys.executable, str(script), *argv, "--rank", str(r), "--world", str(size),
                       "--port", str(port), "--root", str(root), "--device", device_kind,
                       "--parent", str(os.getpid())]
                world.workers.append(subprocess.Popen(
                    cmd, env=dict(os.environ, LOCAL_RANK=str(r)), stdin=subprocess.DEVNULL,
                    stdout=2, stderr=2))
        except BaseException:
            world.abort()
            raise
        return world

    @classmethod
    def of_worker(cls, args) -> "World":
        """A worker's world from its hidden arguments; its card becomes the
        current one."""
        import torch

        world = cls(args.rank, args.world, args.port)
        world.dev = world.device(args.device)
        if world.dev.type == "cuda":
            torch.cuda.set_device(world.dev)
        return world

    def device(self, device):
        """The device this rank computes on: ``device`` in a world of one,
        else ``cuda:<rank>`` or the CPU."""
        import torch

        dev = torch.device(device)
        if self.size == 1 or dev.type != "cuda":
            return dev
        return torch.device("cuda", self.rank)

    def join(self, timeout_s: float = TIMEOUT_S) -> None:
        """Join the program's world and the harness's gloo group; returns
        once every rank has."""
        if self.size == 1:
            return
        import torch.distributed as dist

        from batchelor_torch.parallel import initialize_multihost

        initialize_multihost(f"127.0.0.1:{self.port}", self.size, self.rank,
                             initialization_timeout=timeout_s)
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=timeout_s))

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        if self.group is None:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def same_inputs(self, sums) -> None:
        """Raise unless every rank made the same inputs (``checksum``)."""
        every = self.gather(sums)
        if any(s != every[0] for s in every):
            raise RuntimeError(f"the ranks made different inputs from one seed: {every}")

    def order(self, what: Optional[int] = None) -> Optional[int]:
        """Rank 0 gives ``what`` (``CALL`` or ``STOP``); every rank
        returns it."""
        if self.group is None:
            return what
        import torch
        import torch.distributed as dist

        t = torch.tensor([-1 if what is None else what], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.group)
        return int(t.item())

    def done(self) -> None:
        """A call's end: every rank has synchronized its card."""
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def close(self) -> None:
        """Leave both groups; on rank 0, wait for every worker to exit and
        fail if one did not exit cleanly."""
        if self.group is not None:
            import torch.distributed as dist

            self.group = None
            dist.destroy_process_group()
        codes = []
        for p in self.workers:
            try:
                codes.append(p.wait(timeout=_EXIT_WAIT_S))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self.abort()
        if any(c != 0 for c in codes):
            raise RuntimeError(f"workers ended with codes {codes} (None: killed after "
                               f"{_EXIT_WAIT_S} s)")

    def abort(self) -> None:
        """Kill and reap every worker still running; leave the groups."""
        for p in self.workers:
            if p.poll() is None:
                p.kill()
            p.wait()
        self.workers = []
        self.group = None
        if self.size > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
