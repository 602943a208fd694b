"""Multi-host start-up and the host-major cells mesh.

Counterpart of ``batchelor_tpu/parallel/multihost.py``. The JAX package
starts its processes with ``jax.distributed``; the port starts one process
per device with ``torch.distributed``, from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) or from explicit
arguments. Ranks are numbered host-major (each host's local ranks
contiguous), so contiguous row shards stay on one host and only the
host-boundary collectives cross the network.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike
from .mesh import CellsMesh, make_cells_mesh

__all__ = ["initialize_multihost", "make_multihost_cells_mesh"]

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[float] = None,
) -> None:
    """Initialize the default process group; a no-op when it already is.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` name the world explicitly; without them the group is
    read from torchrun's environment (``env://``), and with neither the
    call is a single-process no-op. The backend is NCCL when a CUDA device
    is present, else gloo. ``initialization_timeout`` in seconds.

    Failure policy, as the JAX package's: only the fully automatic case
    (no arguments) may fall back to one process. When any argument is
    given the caller asked for a multi-process world, and a failure
    raises instead of running 1/N of the job.
    """
    if dist.is_initialized():
        return
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if not explicit and not all(v in os.environ for v in _ENV):
        return                       # nothing names a world: one process
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(initialization_timeout))
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("coordinator_address, num_processes and process_id "
                             "must be given together")
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    else:
        kwargs.update(init_method="env://")
    dist.init_process_group(backend, **kwargs)


def make_multihost_cells_mesh(device: DeviceLike = None) -> CellsMesh:
    """The cells mesh over every rank of the default group. torchrun numbers
    ranks host-major (node, then local rank), so rank order is already the
    host-major order; ``device=None`` is this rank's ``cuda:LOCAL_RANK``."""
    return make_cells_mesh(None, device)
