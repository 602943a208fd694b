"""The cells mesh of the port: one process per device, rows split by rank.

Counterpart of ``batchelor_tpu/parallel/mesh.py``. The JAX package runs its
parallel layer from one controller over a 1-D ``Mesh`` of devices; the port
runs one process per device (``torch.distributed``: NCCL between cards,
gloo between CPU processes). A :class:`CellsMesh` names this process's
place in that world: its process group, rank, world size and device.
Per-cell arrays are padded to a multiple of the world size and split into
equal row shards by rank; small state (batch vectors, rotations, pair
counts) is the same on every rank, and the cross-rank reductions are
explicit collectives over the group.

Without an initialized process group the mesh has world size 1 and no
group, and every collective is the identity (the JAX package's
``axis=None``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, as_tensor, resolve_device
from ..ops.merge_math import gmaybe

__all__ = ["CELLS_AXIS", "CellsMesh", "make_cells_mesh", "cells_sharding",
           "replicated_sharding", "pad_to_multiple", "barrier"]

CELLS_AXIS = "cells"


@dataclass(frozen=True)
class CellsMesh:
    """This process's place in the 1-D cells mesh.

    group: the process group whose ranks share the rows (None: a world of
      one, where every collective is the identity);
    rank, size: this process's rank in it and the number of ranks;
    device: the device this rank computes on.
    """

    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def _backend_fits(group, device: torch.device) -> bool:
    backend = str(dist.get_backend(group)).lower()
    return ("nccl" in backend) if device.type == "cuda" else ("gloo" in backend)


def make_cells_mesh(n_devices: Optional[int] = None, device: DeviceLike = None) -> CellsMesh:
    """The cells mesh over the ranks of the default process group.

    ``device=None`` means ``cuda:LOCAL_RANK`` (torchrun's variable, 0 when
    unset), whose ranks talk over NCCL; it raises without a CUDA device
    unless ``device="cpu"`` is given, whose ranks talk over gloo. The group's
    backend must suit the device. Without an initialized group the mesh
    has one rank and no group. ``n_devices``: None or the world size for
    every rank; 1 for a mesh of this rank alone (no collectives). Any other
    count raises: a rank computes on one device, and there is no fallback
    to CPU devices.
    """
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world and n_devices != 1:
        raise ValueError(
            f"requested {n_devices} devices but the process group has {world} "
            "rank(s); start one process per device (torchrun) and call "
            "initialize_multihost first")
    if not dist.is_initialized() or (n_devices == 1 and world > 1):
        return CellsMesh(group=None, rank=0, size=1, device=dev)
    group = dist.group.WORLD
    if not _backend_fits(group, dev):
        raise ValueError(f"the process group's backend {dist.get_backend(group)!r} "
                         f"does not serve {dev.type} tensors (NCCL for cuda, gloo for cpu)")
    return CellsMesh(group=group, rank=dist.get_rank(group), size=world, device=dev)


@dataclass(frozen=True)
class RowShards:
    """Rows split over the mesh's ranks in equal blocks, columns whole: the
    counterpart of a ``NamedSharding`` of ``P("cells", None)``."""

    mesh: CellsMesh

    def shard(self, x) -> torch.Tensor:
        """This rank's rows of ``x`` (rows a multiple of the world size), on
        the mesh's device."""
        x = as_tensor(x, self.mesh.device)
        if x.shape[0] % self.mesh.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.mesh.size} ranks; "
                             "pad_to_multiple first")
        s = x.shape[0] // self.mesh.size
        return x[self.mesh.rank * s:(self.mesh.rank + 1) * s]

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order, on every rank."""
        return gmaybe(shard, self.mesh.group)


@dataclass(frozen=True)
class Replicated:
    """The whole array on every rank: the counterpart of ``P()``."""

    mesh: CellsMesh

    def put(self, x) -> torch.Tensor:
        return as_tensor(x, self.mesh.device)


def cells_sharding(mesh: CellsMesh) -> RowShards:
    """Rows (cells) split over the ranks, feature columns whole."""
    return RowShards(mesh)


def replicated_sharding(mesh: CellsMesh) -> Replicated:
    return Replicated(mesh)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` (a tensor or an array) with zeros along ``axis`` to a
    multiple; returns (padded, n)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    shape = list(x.shape)
    shape[axis] = target - n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros(shape)], axis), n
    x = np.asarray(x)
    return np.concatenate([x, np.zeros(shape, x.dtype)], axis), n


def barrier(mesh: CellsMesh) -> None:
    """Wait until every rank of the mesh gets here (nothing without a group)."""
    if mesh.group is None:
        return
    if mesh.device.type == "cuda":
        dist.barrier(mesh.group, device_ids=[mesh.device.index or 0])
    else:
        dist.barrier(mesh.group)
