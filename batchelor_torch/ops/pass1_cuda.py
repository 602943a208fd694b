"""Pass 1 of the two-pass kNN with a separate norm vector: kernel K4.

Counterpart of ``benchmarks/knn_pass1_precision_probe.py`` (``pass1`` and
its kernel ``make_kernel(precision)``), the probe that measured how much
pass-1 precision the exact search needs. Unlike K1 (``knn_cuda.py``), the
data norms are a separate fp32 vector, not folded into feature columns, so
a masked row scores -inf instead of needing a finite sentinel.

``pass1_scores(q, x, dn, precision)`` gives the (N_d/32, N_q) sub-chunk
maxima of ``2 q.x - dn``, in one of three precisions:
  * "highest": 6-product 3-way bf16 split (the probe's Precision.HIGHEST);
  * "high3": hh + hl + lh, the probe's manual 3-pass arithmetic;
  * "bf16": one product of bf16-rounded operands with fp32 sums
    (Precision.DEFAULT on the TPU).
On a CUDA tensor the wrapper launches ``csrc/pass1_norm.cu`` (bf16: the
persistent wgmma kernel of ``csrc/wgmma_pass1.cuh``, which K1's bf16 mode
shares, on operands rounded to bf16 first; high3 / highest: the split
mainloop of ``csrc/split_mma.cuh``); on a CPU tensor it uses the plain
version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from ..device import full_fp32_matmul
from .knn_cuda import DT, QT, SUB, _bf16_parts, _round_up, _split_dot

__all__ = ["pass1_scores", "pass1_scores_plain", "pass1_operands", "PRECISIONS"]

PRECISIONS = {"bf16": 0, "high3": 1, "highest": 2}
_PARTS = {"bf16": 1, "high3": 2, "highest": 3}
_KERNEL_TILE = 128        # csrc/pass1_norm.cu takes rows of q and x in multiples of this


def pass1_operands(query: torch.Tensor, data: torch.Tensor, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The probe's ``pass1`` preparation: (q, x, dn) with rows padded to QT
    and DT, features to ``dpad`` (64 for d <= 64, else a multiple of 128),
    and dn = |x|^2, +inf for masked and padding rows."""
    nq, d0 = query.shape
    nd = data.shape[0]
    dpad = 64 if d0 <= 64 else _round_up(d0, 128)
    dev = query.device
    q = torch.zeros((_round_up(nq, QT), dpad), device=dev, dtype=torch.float32)
    x = torch.zeros((_round_up(nd, DT), dpad), device=dev, dtype=torch.float32)
    q[:nq, :d0] = query
    x[:nd, :d0] = data
    ok = torch.zeros(x.shape[0], device=dev, dtype=torch.bool)
    ok[:nd] = valid
    dn = torch.where(ok, (x * x).sum(1), torch.tensor(float("inf"), device=dev))
    return q, x, dn


def _check(q: torch.Tensor, x: torch.Tensor, dn: torch.Tensor, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1] or dn.shape != (x.shape[0],):
        raise ValueError(f"pass1_scores needs (nq, d), (nd, d) and (nd,), got "
                         f"{tuple(q.shape)}, {tuple(x.shape)} and {tuple(dn.shape)}")
    if not all(t.dtype == torch.float32 for t in (q, x, dn)):
        raise TypeError("pass1_scores takes float32 q, x and dn")
    if not (q.device == x.device == dn.device):
        raise ValueError("pass1_scores inputs lie on different devices")
    nq, dp = q.shape
    if nq % _KERNEL_TILE or x.shape[0] % _KERNEL_TILE or dp % 64:
        raise ValueError(f"pass1_scores needs row counts padded to {_KERNEL_TILE} and a "
                         f"feature count padded to 64, got {nq}, {x.shape[0]}, {dp}")


def pass1_scores_plain(q: torch.Tensor, x: torch.Tensor, dn: torch.Tensor,
                       precision: str = "highest", query_tile: int = 4096) -> torch.Tensor:
    """Plain version of K4, with the probe's arithmetic: the same bf16
    split, fp32 products, the norm subtracted, then the max over each 32
    data rows. Runs in query tiles so the score matrix never exists whole."""
    _check(q, x, dn, precision)
    nq, nd = q.shape[0], x.shape[0]
    nparts = _PARTS[precision]
    xs = _bf16_parts(x, nparts)
    out = torch.empty((nd // SUB, nq), device=q.device, dtype=torch.float32)
    with full_fp32_matmul():
        for q0 in range(0, nq, query_tile):
            qs = _bf16_parts(q[q0:q0 + query_tile], nparts)
            s = 2.0 * _split_dot(xs, qs) - dn[:, None]                 # (nd, T)
            out[:, q0:q0 + qs[0].shape[0]] = s.view(nd // SUB, SUB, -1).amax(1)
    return out


def _launch_fn():
    return _build.kernel_function(
        "pass1_norm", "pass1_norm_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


def pass1_scores(q: torch.Tensor, x: torch.Tensor, dn: torch.Tensor,
                 precision: str = "highest") -> torch.Tensor:
    """(N_d/32, N_q) sub-chunk maxima ``out[c, j] = max_{r in c} 2 q_j.x_r - dn_r``.

    ``q``/``x``/``dn`` as ``pass1_operands`` makes them. A CPU tensor takes
    the plain version. On the card "bf16" rounds ``q`` and ``x`` to bf16
    (to nearest even) before its kernel, which stores the maxima
    query-major, (N_q, N_d/32): the result is its ``.t()`` view, so
    ``knn_cuda._select_subchunks`` reads its rows without a copy; "high3"
    and "highest" return a contiguous (N_d/32, N_q) matrix."""
    _check(q, x, dn, precision)
    if q.device.type == "cpu":
        return pass1_scores_plain(q, x, dn, precision)
    if q.device.type != "cuda":
        raise ValueError(f"pass1_scores runs on CUDA or CPU tensors, not {q.device}")
    if not (q.is_contiguous() and x.is_contiguous() and dn.is_contiguous()):
        raise ValueError("pass1_scores kernel needs contiguous inputs")
    nq, dp = q.shape
    nd = x.shape[0]
    bf16 = precision == "bf16"
    if bf16:
        if dn.data_ptr() % 16:
            raise ValueError("pass1_scores bf16 kernel needs dn 16-byte aligned")
        q, x = q.to(torch.bfloat16), x.to(torch.bfloat16)
    out = torch.empty((nq, nd // SUB) if bf16 else (nd // SUB, nq), device=q.device,
                      dtype=torch.float32)
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), x.data_ptr(), dn.data_ptr(), out.data_ptr(),
                 nq, nd, dp, PRECISIONS[precision], stream)
    if err != 0:
        raise RuntimeError(f"pass1_scores kernel launch failed: error {err} (a cudaError_t; "
                           f"10000 + a CUresult when the bf16 kernel's tensor map fails)")
    pass1_scores.launches += 1
    return out.t() if bf16 else out


pass1_scores.launches = 0
