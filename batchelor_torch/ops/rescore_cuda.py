"""The two-pass kNN's rescore of the selected sub-chunks: kernel K3.

Counterpart of ``benchmarks/knn_dma_rescore_probe.py`` (``dma_gather`` and
its kernel ``_gather_kernel``): the TPU kernel copies each query's selected
(32, d) sub-chunks into a contiguous buffer and leaves the rescore to XLA.
Here the gather is fused with the product that consumes it:

    rescore_subchunks(q, data3, dn2, top_sub)[i, j * 32 + r]
        = 2 q_i . data3[top_sub[i, j], r] - dn2[top_sub[i, j], r]

in fp32 sums, and the gathered blocks never reach device memory.
``gather_subchunks_plain`` is K3's own contract (``data3[top_sub]``), and
``rescore_subchunks_plain`` the gather + batched product that the kernel
replaces. On a CUDA tensor ``rescore_subchunks`` launches
``csrc/rescore_chunks.cu``, which sorts the (query, rank) slots by
sub-chunk on the card and stages each selected sub-chunk once per 64 slots
that chose it (``tools/k3_emulate.py`` models it on the CPU), or, when the
slots are too few a sub-chunk to share blocks, rescores query by query; on
a CPU tensor it uses the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..device import full_fp32_matmul

__all__ = ["rescore_subchunks", "rescore_subchunks_plain", "gather_subchunks_plain"]

SUB = 32                  # data rows per sub-chunk
_PLAIN_GATHER_BYTES = 1 << 28


def gather_subchunks_plain(top_sub: torch.Tensor, data3: torch.Tensor) -> torch.Tensor:
    """(nq, ks, SUB, d) copy of each query's selected sub-chunks: what the
    TPU kernel writes."""
    return data3[top_sub]


def _check(q, data3, dn2, top_sub) -> None:
    if (q.dim() != 2 or data3.dim() != 3 or data3.shape[1] != SUB
            or data3.shape[2] != q.shape[1] or dn2.shape != data3.shape[:2]
            or top_sub.dim() != 2 or top_sub.shape[0] != q.shape[0]):
        raise ValueError(f"rescore_subchunks needs q (nq, d), data3 (C32, {SUB}, d), "
                         f"dn2 (C32, {SUB}) and top_sub (nq, ks), got {tuple(q.shape)}, "
                         f"{tuple(data3.shape)}, {tuple(dn2.shape)}, {tuple(top_sub.shape)}")
    if not (q.dtype == data3.dtype == dn2.dtype == torch.float32):
        raise TypeError("rescore_subchunks takes float32 q, data3 and dn2")
    if top_sub.dtype != torch.int64:
        raise TypeError(f"rescore_subchunks takes int64 sub-chunk ids, got {top_sub.dtype}")
    if not (q.device == data3.device == dn2.device == top_sub.device):
        raise ValueError("rescore_subchunks inputs lie on different devices")


def rescore_subchunks_plain(q: torch.Tensor, data3: torch.Tensor, dn2: torch.Tensor,
                            top_sub: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the gather, a batched product in full
    fp32 and the norms subtracted, in query tiles whose gather stays within
    256 MB."""
    _check(q, data3, dn2, top_sub)
    nq, d = q.shape
    ks = top_sub.shape[1]
    out = torch.empty((nq, ks * SUB), device=q.device, dtype=torch.float32)
    tile = max(1, _PLAIN_GATHER_BYTES // (ks * SUB * max(d, 1) * 4))
    with full_fp32_matmul():
        for t0 in range(0, nq, tile):
            ct = top_sub[t0:t0 + tile]
            n = ct.shape[0]
            gx = gather_subchunks_plain(ct, data3).view(n, ks * SUB, d)
            out[t0:t0 + n] = (2.0 * torch.bmm(gx, q[t0:t0 + n, :, None])[:, :, 0]
                              - dn2[ct].view(n, ks * SUB))
    return out


def _launch_fn():
    return _build.kernel_function(
        "rescore_chunks", "rescore_subchunks_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


SCRATCH_BYTES_PER_SLOT = 12      # a sorting call's scratch: the (slot, sub-chunk)
SCRATCH_BYTES_PER_SUBCHUNK = 8   # pairs and ranks, and the bucket counts and offsets


def workspace_ints(nq: int, ks: int, c32: int) -> int:
    """int32 scratch of one kernel call that sorts the slots: the (slot,
    sub-chunk) pairs sorted by sub-chunk, each slot's rank in its bucket, the
    bucket counts and their offsets."""
    return (SCRATCH_BYTES_PER_SLOT * nq * ks + SCRATCH_BYTES_PER_SUBCHUNK * (c32 + 1)) // 4


def kernel_plan(nq: int, ks: int, c32: int) -> tuple[bool, int]:
    """(whether a kernel call of these shapes sorts the slots by sub-chunk,
    the sorted slots of a work item), as the kernel's library decides."""
    fn = _build.kernel_function("rescore_chunks", "rescore_subchunks_sorts",
                                [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    p = ctypes.c_int(0)
    return bool(fn(nq, ks, c32, ctypes.byref(p))), p.value


def rescore_subchunks(q: torch.Tensor, data3: torch.Tensor, dn2: torch.Tensor,
                      top_sub: torch.Tensor) -> torch.Tensor:
    """(nq, ks * SUB) fp32 scores ``2 q_i.x_r - dn_r`` of the rows of each
    query's selected sub-chunks, sub-chunk by sub-chunk in ``top_sub``'s
    order. ``top_sub`` ids must lie in [0, C32). A CPU tensor takes the
    plain version. On the card the call makes four launches (a memset and
    three kernels), or one where the slots are few a sub-chunk
    (``kernel_plan``), and reads nothing back to the host."""
    _check(q, data3, dn2, top_sub)
    if q.device.type == "cpu":
        return rescore_subchunks_plain(q, data3, dn2, top_sub)
    if q.device.type != "cuda":
        raise ValueError(f"rescore_subchunks runs on CUDA or CPU tensors, not {q.device}")
    if not all(t.is_contiguous() for t in (q, data3, dn2, top_sub)):
        raise ValueError("rescore_subchunks kernel needs contiguous inputs")
    if data3.data_ptr() % 16 or dn2.data_ptr() % 16:
        raise ValueError("rescore_subchunks kernel needs 16-byte aligned data3 and dn2")
    nq, d = q.shape
    c32 = data3.shape[0]
    ks = top_sub.shape[1]
    if nq * ks >= 2 ** 31:
        raise ValueError(f"rescore_subchunks kernel takes fewer than 2^31 slots, got "
                         f"{nq} x {ks}; rescore in query tiles")
    out = torch.empty((nq, ks * SUB), device=q.device, dtype=torch.float32)
    if nq == 0 or ks == 0:
        return out
    sorts, _ = kernel_plan(nq, ks, c32)
    work = (torch.empty(workspace_ints(nq, ks, c32), device=q.device, dtype=torch.int32)
            if sorts else None)
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), data3.data_ptr(), dn2.data_ptr(), top_sub.data_ptr(),
                 out.data_ptr(), None if work is None else work.data_ptr(), nq, ks, d, c32,
                 stream)
    if err != 0:
        raise RuntimeError(f"rescore_subchunks kernel launch failed: cudaError {err}")
    rescore_subchunks.launches += 1
    return out


rescore_subchunks.launches = 0
