"""Out-of-core CSR storage and blocked streaming to the device.

Counterpart of ``batchelor_tpu/io/csr.py`` (the analog of the reference's
DelayedArray/beachmat block layer, SURVEY.md L10): cell-major CSR matrices
kept on disk, densified block by block, either on the host through the
C++ runtime (``dense_blocks``) or on the card from the shipped nonzeros
(``device_dense_blocks``). The on-disk format is the JAX package's,
byte for byte, so either package reads the other's stores.

The JAX package's ``auto_blocks`` ships nonzeros below 25% density and
densifies on the host above it, a TPU figure. On an H100 host the sparse
transfer (pinned copies, densified on the card) beat the host densify and
its pageable copy at every density measured, up to 100% (``chip_smoke.py``
phase 15, PERF.md), so the port's engines always stream through
``device_dense_blocks`` and take no ``transfer`` option.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..native import bindings as nat

__all__ = ["CSRCells", "dense_blocks", "device_dense_blocks"]

_MAGIC = "batchelor-csr-v1"


@dataclass
class CSRCells:
    """Cells-in-rows CSR matrix (N cells x G genes)."""

    data: np.ndarray       # float32 nnz values
    indices: np.ndarray    # int32 column ids
    indptr: np.ndarray     # int64, len N+1
    n_genes: int
    gene_names: Optional[list] = None

    @property
    def n_cells(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_cells, self.n_genes)

    @staticmethod
    def from_dense(x: np.ndarray, gene_names=None) -> "CSRCells":
        x = np.asarray(x, dtype=np.float32)
        mask = x != 0
        indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))]).astype(np.int64)
        rows, cols = np.nonzero(mask)
        return CSRCells(
            data=x[rows, cols].astype(np.float32),
            indices=cols.astype(np.int32),
            indptr=indptr,
            n_genes=x.shape[1],
            gene_names=list(gene_names) if gene_names is not None else None,
        )

    def to_dense(self, row_start: int = 0, row_end: Optional[int] = None) -> np.ndarray:
        if row_end is None:
            row_end = self.n_cells
        return nat.csr_densify(self.data, self.indices, self.indptr, row_start, row_end,
                               self.n_genes)

    def row_sums(self) -> np.ndarray:
        """Per-cell totals (library sizes)."""
        return nat.csr_row_sums(self.data, self.indptr, self.n_cells)

    def select_genes(self, subset: Sequence[int]) -> "CSRCells":
        subset = np.asarray(subset)
        col_map = np.full(self.n_genes, -1, dtype=np.int32)
        col_map[subset] = np.arange(subset.shape[0], dtype=np.int32)
        d, i, p = nat.csr_select_columns(self.data, self.indices, self.indptr, col_map)
        names = [self.gene_names[j] for j in subset] if self.gene_names is not None else None
        return CSRCells(d, i, p, int(subset.shape[0]), names)

    def select_cells(self, rows: Sequence[int]) -> "CSRCells":
        rows = np.asarray(rows, dtype=np.int64)
        ip = np.asarray(self.indptr)
        counts = ip[rows + 1] - ip[rows]
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        src = np.repeat(ip[rows] - indptr[:-1], counts) + np.arange(indptr[-1])
        return CSRCells(np.asarray(self.data)[src], np.asarray(self.indices)[src], indptr,
                        self.n_genes, self.gene_names)

    # -- on-disk format: header json + raw arrays ---------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        header = {
            "magic": _MAGIC,
            "n_cells": self.n_cells,
            "n_genes": self.n_genes,
            "nnz": int(self.data.shape[0]),
            "gene_names": self.gene_names,
        }
        with open(os.path.join(path, "header.json"), "w") as fh:
            json.dump(header, fh)
        self.data.tofile(os.path.join(path, "data.f32"))
        self.indices.tofile(os.path.join(path, "indices.i32"))
        self.indptr.tofile(os.path.join(path, "indptr.i64"))

    @staticmethod
    def load(path: str, mmap: bool = True) -> "CSRCells":
        with open(os.path.join(path, "header.json")) as fh:
            header = json.load(fh)
        if header.get("magic") != _MAGIC:
            raise ValueError(f"{path} is not a batchelor CSR store")

        def load(name, dtype):
            f = os.path.join(path, name)
            return np.memmap(f, dtype=dtype, mode="r") if mmap else np.fromfile(f, dtype=dtype)

        return CSRCells(
            data=load("data.f32", np.float32),
            indices=load("indices.i32", np.int32),
            indptr=load("indptr.i64", np.int64),
            n_genes=header["n_genes"],
            gene_names=header.get("gene_names"),
        )


def row_l2_norms(csr: CSRCells, subset=None) -> np.ndarray:
    """Per-cell L2 norms over the ``subset`` genes, fp64, O(nnz) on the host
    (the out-of-core cosine_norm(mode='l2norm'))."""
    s = csr if subset is None else csr.select_genes(np.asarray(subset))
    sq = np.zeros(s.n_cells, np.float64)
    nz = np.diff(s.indptr) > 0
    if nz.any():
        sq[nz] = np.add.reduceat(np.asarray(s.data, np.float64) ** 2, s.indptr[:-1][nz])
    return np.sqrt(sq)


def dense_blocks(
    csr: CSRCells, block_rows: int = 8192, pad: bool = True
) -> Iterator[Tuple[np.ndarray, int]]:
    """Stream (host block, n_valid) dense row blocks, densified by the C++
    runtime; the final block is zero-padded to ``block_rows`` when ``pad``."""
    n = csr.n_cells
    for start in range(0, n, block_rows):
        end = min(start + block_rows, n)
        block = csr.to_dense(start, end)
        n_valid = end - start
        if pad and n_valid < block_rows:
            block = np.vstack([block, np.zeros((block_rows - n_valid, csr.n_genes), np.float32)])
        yield block, n_valid


class _Staging:
    """One host buffer that a block's values, columns and row offsets pass
    through on their way to ``dev``: pinned on a CUDA device, so the copies
    run asynchronously, and refilled only after the previous copy is done."""

    def __init__(self, nnz_max: int, rows_max: int, dev: torch.device):
        self.dev = dev
        pin = dev.type == "cuda"
        self.vals = torch.empty(nnz_max, dtype=torch.float32, pin_memory=pin)
        self.cols = torch.empty(nnz_max, dtype=torch.int32, pin_memory=pin)
        self.ptr = torch.empty(rows_max + 1, dtype=torch.int64, pin_memory=pin)
        self.done = torch.cuda.Event() if pin else None

    def send(self, vals: np.ndarray, cols: np.ndarray, ptr: np.ndarray):
        if self.done is not None:
            self.done.synchronize()
        out = []
        for buf, src in ((self.vals, vals), (self.cols, cols), (self.ptr, ptr)):
            view = buf[: src.shape[0]]
            view.numpy()[:] = src
            out.append(view.to(self.dev, non_blocking=True) if self.done is not None
                       else view.clone())
        if self.done is not None:
            self.done.record()
        return out


def device_dense_blocks(
    csr: CSRCells, block_rows: int = 8192, pad: bool = True, *, mesh=None,
    device: DeviceLike = None,
) -> Iterator[Tuple[torch.Tensor, int]]:
    """Sparse-transfer counterpart of :func:`dense_blocks`: each block
    travels as its nonzeros' values (fp32), columns (int32) and row offsets
    (int64), 8 bytes a nonzero instead of 4 a slot, and is densified on
    ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``). Each nonzero owns its slot, so the values are written,
    not added, and the block is bit-identical to the host densify; the flat
    slot index is built in int64 on the device, so no block is too large for
    it. Yields (device block, n_valid); the final block has ``block_rows``
    rows when ``pad``, else ``n_valid``.

    With ``mesh`` (a ``parallel.mesh.CellsMesh``; its device is used)
    ``block_rows`` is rounded up to a multiple of the world size, each
    block's rows split into equal spans by rank, and each rank receives and
    densifies only its own span's nonzeros: it yields (its rows of the
    block, how many of them are cells), with ``block_rows / world size``
    rows when ``pad``."""
    n, g = csr.shape
    if mesh is not None:
        dev = mesh.device
        block_rows = -(-block_rows // mesh.size) * mesh.size
        rows_each = block_rows // mesh.size
        spans = [(min(s + mesh.rank * rows_each, n), min(s + (mesh.rank + 1) * rows_each, n))
                 for s in range(0, n, block_rows)]
    else:
        dev = resolve_device(device)
        rows_each = block_rows
        spans = [(s, min(s + block_rows, n)) for s in range(0, n, block_rows)]
    ip = np.asarray(csr.indptr)
    nnz_max = max((int(ip[end] - ip[start]) for start, end in spans), default=0)
    stage = _Staging(nnz_max, min(rows_each, n), dev)
    for start, end in spans:
        lo, hi = int(ip[start]), int(ip[end])
        vals, cols, ptr = stage.send(csr.data[lo:hi], csr.indices[lo:hi], ip[start:end + 1])
        n_valid = end - start
        rows = torch.repeat_interleave(torch.arange(n_valid, device=dev), ptr.diff(),
                                       output_size=hi - lo)
        out = torch.zeros(((rows_each if pad else n_valid) * g,), dtype=torch.float32,
                          device=dev)
        out[rows * g + cols] = vals
        yield out.view(-1, g), n_valid
