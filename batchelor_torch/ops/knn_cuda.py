"""Exact two-pass kNN around the sub-chunk-max kernel K1.

Counterpart of ``batchelor_tpu/ops/knn_pallas.py``.

Pass 1 (kernel K1, ``chunk_max_scores``): for every query and every 32-row
data sub-chunk, the maximum of the score ``s = 2 q.x - |x|^2`` over the
sub-chunk. Only this (N_d/32, N_q) matrix is stored; the score matrix never
is. The data norms ride in two folded feature columns (``_prep_pass1``).

Pass 2: exact selection, then an exact rescore.
  1. The sub-chunk maxima are maxed in groups of CHUNK/SUB = 4 to give
     128-row chunk maxima.
  2. The top-k 128-chunks per query: the k-th largest chunk maximum bounds
     the k-th best score from below (the k chunk maxima are k distinct
     scores), so the top-k chunks hold every true top-k neighbour.
  3. Among those chunks' 4k sub-chunks, the top-k sub-chunks by maximum,
     by the same argument. Up to SINGLE_LEVEL_MAX sub-chunks one flat top-k
     replaces steps 1-3. Both selections go through kernel K2
     (``topk_rows``), whose k positions are distinct even under ties, as
     the argument needs.
  4. The selected sub-chunks are rescored in full fp32 as whole (32, d)
     blocks by kernel K3's counterpart (``rescore_cuda.py``), which reads
     them in place; the top-k of the rescored rows are the result.

The result is exact up to ties: pass-1 selection carries ~2^-21 relative
score error with the 3-product split (``six_pass`` brings it to fp32
rounding), and ~2^-8 with bf16 inputs, so neighbours that close to the k-th
best count as ties. Reported distances are always full-fp32 rescores.
Masked data rows get the finite norm sentinel 1e30 in pass 1 (the bf16
split of inf would give NaN) and an infinite norm in the rescore.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..device import full_fp32_matmul
from .rescore_cuda import (SCRATCH_BYTES_PER_SLOT, SCRATCH_BYTES_PER_SUBCHUNK,
                           rescore_subchunks)
from .topk_cuda import select_topk

__all__ = ["chunk_max_scores", "chunk_max_scores_plain", "query_knn_two_pass"]

CHUNK = 128               # selection chunk (exactness granularity of step 2)
SUB = 32                  # data rows per sub-chunk (gather/rescore granularity)
RATIO = CHUNK // SUB
QT = 512                  # query rows are padded to a multiple of this
DT = 1024                 # data rows are padded to a multiple of this
SINGLE_LEVEL_MAX = 8192   # sub-chunk count up to which one flat top-k is used
_KERNEL_TILE = 128        # csrc/chunk_max.cu takes rows of q and x in multiples of this
_MODES = {"bf16": 0, "split3": 1, "split6": 2}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _bf16_parts(a: torch.Tensor, n: int) -> list:
    """``a`` as n bf16-representable fp32 parts: hi = bf16(a), then bf16 of
    what remains, as the reference splits fp32 operands."""
    parts, rest = [], a
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        parts.append(p)
        rest = rest - p
    return parts


def _split_dot(xs: list, qs: list) -> torch.Tensor:
    """(nd, T) products of the split operands (1, 2 or 3 parts each): one
    product, hh + hl + lh, or the 6 products of the three-way split."""
    dot = lambda i, j: xs[i] @ qs[j].T
    if len(xs) == 1:
        return dot(0, 0)
    if len(xs) == 2:
        return dot(0, 0) + dot(0, 1) + dot(1, 0)
    return (dot(0, 0) + (dot(0, 1) + dot(1, 0))
            + (dot(0, 2) + dot(1, 1) + dot(2, 0)))


def _check_pass1_inputs(q: torch.Tensor, x: torch.Tensor) -> None:
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"chunk_max_scores needs (nq, d) and (nd, d), got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    if q.dtype != x.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"chunk_max_scores takes two float32 or two bfloat16 "
                        f"matrices, got {q.dtype} and {x.dtype}")
    if q.device != x.device:
        raise ValueError("chunk_max_scores inputs lie on different devices")
    nq, dp = q.shape
    if nq % _KERNEL_TILE or x.shape[0] % _KERNEL_TILE or dp % 64:
        raise ValueError(f"chunk_max_scores needs row counts padded to "
                         f"{_KERNEL_TILE} and a feature count padded to 64, got "
                         f"{nq}, {x.shape[0]}, {dp}")


def chunk_max_scores_plain(q: torch.Tensor, x: torch.Tensor, six_pass: bool = False,
                           query_tile: int = 4096) -> torch.Tensor:
    """Plain version of K1, with the reference's arithmetic: the same bf16
    split, fp32 products, and the max over each 32 data rows. Runs in query
    tiles so the whole score matrix never exists."""
    _check_pass1_inputs(q, x)
    nq, nd = q.shape[0], x.shape[0]
    out = torch.empty((nd // SUB, nq), device=q.device, dtype=torch.float32)
    nparts = 1 if q.dtype == torch.bfloat16 else (3 if six_pass else 2)
    xs = [x.float()] if nparts == 1 else _bf16_parts(x, nparts)
    with full_fp32_matmul():
        for q0 in range(0, nq, query_tile):
            qt = q[q0:q0 + query_tile]
            qs = [qt.float()] if nparts == 1 else _bf16_parts(qt, nparts)
            s = _split_dot(xs, qs)                          # (nd, T)
            out[:, q0:q0 + qt.shape[0]] = (2.0 * s).view(nd // SUB, SUB, -1).amax(1)
    return out


def _launch_fn():
    return _build.kernel_function(
        "chunk_max", "chunk_max_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


def chunk_max_scores(q: torch.Tensor, x: torch.Tensor, six_pass: bool = False) -> torch.Tensor:
    """(N_d/32, N_q) sub-chunk maxima of the score matrix, transposed as the
    reference emits them: ``out[c, j] = max_{r in sub-chunk c} 2 q_j.x_r``.

    ``q``/``x`` come as ``_prep_pass1`` leaves them: padded rows, norms
    folded into the last two feature columns, both fp32 (3-product split,
    or 6 products with ``six_pass``) or both bf16 (one product). A CPU
    tensor takes the plain version. On the card the bf16 kernel stores the
    maxima query-major, (N_q, N_d/32), and the result is its ``.t()`` view,
    so ``_select_subchunks`` reads its rows without a copy; the fp32 modes
    return a contiguous (N_d/32, N_q) matrix."""
    _check_pass1_inputs(q, x)
    if q.device.type == "cpu":
        return chunk_max_scores_plain(q, x, six_pass)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_max_scores runs on CUDA or CPU tensors, not {q.device}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("chunk_max_scores kernel needs contiguous inputs")
    nq, dp = q.shape
    nd = x.shape[0]
    bf16 = q.dtype == torch.bfloat16
    mode = _MODES["bf16" if bf16 else ("split6" if six_pass else "split3")]
    shape = (nq, nd // SUB) if bf16 else (nd // SUB, nq)
    out = torch.empty(shape, device=q.device, dtype=torch.float32)
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nd, dp, mode, stream)
    if err != 0:
        raise RuntimeError(f"chunk_max_scores kernel launch failed: error {err} (a cudaError_t; "
                           f"10000 + a CUresult when the bf16 kernel's tensor map fails)")
    chunk_max_scores.launches += 1
    return out.t() if bf16 else out


chunk_max_scores.launches = 0


def _pass1_operands(query: torch.Tensor, data: torch.Tensor, data_valid: torch.Tensor,
                    bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad and fold the data norms into two feature columns: K1's (q, x).

    x gets (dn_hi, dn_lo) and q gets (-0.5, -0.5) in the last two of
    ``dpad`` columns, so q.x = raw_q.raw_x - |x|^2 / 2; dn_hi is bf16-exact,
    so every split mode reproduces it. Masked and padding data rows carry
    the finite norm 1e30. With ``bf16`` the operands are cast to bf16 (one
    product, fp32 sums)."""
    nq, d0 = query.shape
    nd = data.shape[0]
    dpad = 64 if d0 <= 62 else _round_up(d0 + 2, 128)
    dev = query.device
    q = torch.zeros((_round_up(nq, QT), dpad), device=dev, dtype=torch.float32)
    x = torch.zeros((_round_up(nd, DT), dpad), device=dev, dtype=torch.float32)
    q[:nq, :d0] = query
    x[:nd, :d0] = data
    valid = torch.zeros(x.shape[0], device=dev, dtype=torch.bool)
    valid[:nd] = data_valid
    dn = (x * x).sum(1).masked_fill_(~valid, 1e30)
    dn_hi = dn.to(torch.bfloat16).float()
    x[:, dpad - 2] = dn_hi
    x[:, dpad - 1] = dn - dn_hi
    q[:, dpad - 2:] = -0.5
    if bf16:
        q, x = q.to(torch.bfloat16), x.to(torch.bfloat16)
    return q, x


def _prep_pass1(query: torch.Tensor, data: torch.Tensor, data_valid: torch.Tensor,
                bf16: bool = False, six_pass: bool = False) -> torch.Tensor:
    """Pass 1: the (C32, nq_pad) sub-chunk maxima of ``_pass1_operands``."""
    q, x = _pass1_operands(query, data, data_valid, bf16)
    return chunk_max_scores(q, x, six_pass)


def _select_subchunks(m_t: torch.Tensor, k: int) -> torch.Tensor:
    """(C32, nq) sub-chunk maxima -> (nq, ks) ids of the top sub-chunks,
    ks = min(k, candidate count). Flat top-k up to SINGLE_LEVEL_MAX
    sub-chunks, else the 128-chunk -> sub-chunk hierarchy. The chunk count
    is padded to a multiple of 128 with -inf chunks, which are never chosen
    while a real chunk remains."""
    c32, nq = m_t.shape
    c128 = c32 // RATIO
    kc = min(k, c128)
    ks = min(k, RATIO * kc)
    m32 = m_t.t().contiguous()     # (nq, C32); no copy for the bf16 kernel's view
    if c32 <= SINGLE_LEVEL_MAX:
        return select_topk(m32, ks)[1].long()
    c128p = max(_round_up(c128, 128), 128)
    if c128p != c128:
        m32 = F.pad(m32, (0, (c128p - c128) * RATIO), value=float("-inf"))
    m3 = m32.view(nq, c128p, RATIO)
    top_chunks = select_topk(m3.amax(2), kc)[1].long()  # (nq, kc)
    sub = torch.gather(m3, 1, top_chunks[:, :, None].expand(-1, -1, RATIO))
    sub_ids = (top_chunks[:, :, None] * RATIO
               + torch.arange(RATIO, device=m_t.device)).reshape(nq, RATIO * kc)
    pos = select_topk(sub.reshape(nq, RATIO * kc), ks)[1].long()
    return sub_ids.gather(1, pos)


def _chunked_view(data: torch.Tensor, data_valid: torch.Tensor):
    """Data rows padded to DT as (C32, SUB, d) fp32 blocks, and per-row
    norms (C32, SUB) with +inf for masked and padding rows."""
    nd, d0 = data.shape
    x = torch.zeros((_round_up(nd, DT), d0), device=data.device, dtype=torch.float32)
    x[:nd] = data
    valid = torch.zeros(x.shape[0], device=data.device, dtype=torch.bool)
    valid[:nd] = data_valid
    dn = (x * x).sum(1).masked_fill_(~valid, float("inf"))
    return x.view(-1, SUB, d0), dn.view(-1, SUB)


def _rescore_chunks(query: torch.Tensor, data3: torch.Tensor, dn2: torch.Tensor,
                    top_sub: torch.Tensor, k: int, with_scores: bool, max_bytes: int):
    """Rescore the selected sub-chunks in full fp32 (kernel K3's counterpart,
    ``rescore_subchunks``, which never stores the gathered blocks) and take
    the top k, in query tiles that bound the (T, ks * SUB) score block and
    the kernel's scratch by ``max_bytes``. Returns (indices (nq, k) int64,
    squared distances or None)."""
    q = query.float()
    nq = q.shape[0]
    ks = top_sub.shape[1]
    budget = max_bytes - SCRATCH_BYTES_PER_SUBCHUNK * (data3.shape[0] + 1)
    tile = max(1, budget // (ks * (SUB * 4 + SCRATCH_BYTES_PER_SLOT)))
    idxs, vals = [], []
    for t0 in range(0, nq, tile):
        ct = top_sub[t0:t0 + tile]
        s = rescore_subchunks(q[t0:t0 + tile], data3, dn2, ct)
        v, pos = select_topk(s, k)
        pos = pos.long()
        idxs.append(ct.gather(1, pos // SUB) * SUB + pos % SUB)
        vals.append(v)
    idx = torch.cat(idxs)
    if not with_scores:
        return idx, None
    qn = (q * q).sum(1, keepdim=True)
    return idx, torch.clamp(qn - torch.cat(vals), min=0.0)


def default_max_bytes(device: torch.device) -> int:
    """Memory the search may hold in its largest buffers: a quarter of the
    card's free memory, or 1 GiB on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free // 4
    return 1 << 30


def query_knn_two_pass(
    query: torch.Tensor,
    data: torch.Tensor,
    k: int,
    data_valid: torch.Tensor,
    *,
    bf16: bool = False,
    six_pass: bool = False,
    with_scores: bool = True,
    max_bytes: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Exact kNN by the two-pass search (the reference's ``query_knn_tpu``):
    (indices (nq, k) int64, squared distances (nq, k) fp32 or None).

    Queries run in pieces so the pass-1 maxima and their selection buffers
    (about 3 x 4 bytes x N_d/32 per query) stay within ``max_bytes``
    (default: ``default_max_bytes``); the rescore's score block is bounded
    the same way."""
    if max_bytes is None:
        max_bytes = default_max_bytes(query.device)
    nq = query.shape[0]
    c32 = _round_up(data.shape[0], DT) // SUB
    piece = max(QT, max_bytes // (3 * 4 * c32) // QT * QT)
    tops = []
    for q0 in range(0, nq, piece):
        qp = query[q0:q0 + piece]
        m_t = _prep_pass1(qp, data, data_valid, bf16, six_pass)
        tops.append(_select_subchunks(m_t, k)[:qp.shape[0]])
        del m_t
    top_sub = torch.cat(tops)
    data3, dn2 = _chunked_view(data, data_valid)
    return _rescore_chunks(query, data3, dn2, top_sub, k, with_scores, max_bytes)
