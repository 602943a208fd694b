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
``csrc/rescore_chunks.cu``; on a CPU tensor it uses the plain version.
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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )


def rescore_subchunks(q: torch.Tensor, data3: torch.Tensor, dn2: torch.Tensor,
                      top_sub: torch.Tensor) -> torch.Tensor:
    """(nq, ks * SUB) fp32 scores ``2 q_i.x_r - dn_r`` of the rows of each
    query's selected sub-chunks, sub-chunk by sub-chunk in ``top_sub``'s
    order. ``top_sub`` ids must lie in [0, C32). A CPU tensor takes the
    plain version."""
    _check(q, data3, dn2, top_sub)
    if q.device.type == "cpu":
        return rescore_subchunks_plain(q, data3, dn2, top_sub)
    if q.device.type != "cuda":
        raise ValueError(f"rescore_subchunks runs on CUDA or CPU tensors, not {q.device}")
    if not all(t.is_contiguous() for t in (q, data3, dn2, top_sub)):
        raise ValueError("rescore_subchunks kernel needs contiguous inputs")
    if data3.data_ptr() % 16:
        raise ValueError("rescore_subchunks kernel needs 16-byte aligned data3")
    nq, d = q.shape
    ks = top_sub.shape[1]
    out = torch.empty((nq, ks * SUB), device=q.device, dtype=torch.float32)
    if nq == 0 or ks == 0:
        return out
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), data3.data_ptr(), dn2.data_ptr(), top_sub.data_ptr(),
                 out.data_ptr(), nq, ks, d, stream)
    if err != 0:
        raise RuntimeError(f"rescore_subchunks kernel launch failed: cudaError {err}")
    rescore_subchunks.launches += 1
    return out


rescore_subchunks.launches = 0
