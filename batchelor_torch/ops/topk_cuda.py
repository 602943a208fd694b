"""Row-wise top-k with the reference's tie rule: kernel K2.

Counterpart of ``batchelor_tpu/ops/topk_pallas.py``. ``topk_rows(x, k)``
returns the k largest entries of each row of an (N, W) fp32 matrix, values
descending, with int32 columns. Ties go to the lower column, and the k
columns of a row are distinct, also among equal values and when fewer than
k finite entries remain (``lax.top_k``'s rule). The two-pass kNN's
exactness argument needs the distinct columns (``knn_cuda.py``).

On a CUDA tensor the wrapper launches ``csrc/topk_rows.cu`` (one warp per
row streaming it once, so rows of any width); on a CPU tensor it uses the
plain version, a stable descending sort. ``torch.topk`` does not promise
the tie rule.

The reference kernel repeats a column once a row has fewer than k entries
above -inf (it masks a taken column with -inf, which a -inf column already
holds). No caller of the main path reaches that case; the port follows
``lax.top_k`` there.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

__all__ = ["topk_rows", "topk_rows_plain", "select_topk", "MAX_K"]

MAX_K = 64
_INT32_MAX = 2**31 - 1


def topk_rows_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: (values, int32 columns) by a stable sort."""
    vals, cols = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], cols[:, :k].to(torch.int32)


def _launch_fn():
    return _build.kernel_function(
        "topk_rows", "topk_rows_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )


def topk_rows(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 columns) of the k largest entries of each row, descending.

    ``x``: (N, W) fp32, contiguous, no NaN; 1 <= k <= min(64, W) on the
    card, any W that int32 columns can name. A CPU tensor takes the plain
    version."""
    if x.dim() != 2:
        raise ValueError(f"topk_rows needs a 2-D matrix, got shape {tuple(x.shape)}")
    n, w = x.shape
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must lie in [1, {w}]")
    if x.device.type == "cpu":
        return topk_rows_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk_rows runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"topk_rows kernel takes float32, got {x.dtype}")
    if k > MAX_K:
        raise ValueError(f"topk_rows kernel takes k <= {MAX_K}")
    if max(n, w) > _INT32_MAX:
        raise ValueError(f"topk_rows kernel takes N and W below 2^31 (int32 columns), "
                         f"got {n} x {w}")
    if not x.is_contiguous():
        raise ValueError("topk_rows kernel needs a contiguous matrix")
    vals = torch.empty((n, k), device=x.device, dtype=torch.float32)
    cols = torch.empty((n, k), device=x.device, dtype=torch.int32)
    if n == 0:
        return vals, cols
    fn = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), vals.data_ptr(), cols.data_ptr(), n, w, k, stream)
    if err != 0:
        raise RuntimeError(f"topk_rows kernel launch failed: cudaError {err}")
    topk_rows.launches += 1
    return vals, cols


topk_rows.launches = 0


def select_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k selection of the kNN searches: K2 for fp32 with k <= 64 (on the
    card the kernel, on the CPU its plain version), the stable sort for
    fp64 or larger k, as the reference uses ``lax.top_k`` there."""
    if x.dtype == torch.float32 and k <= MAX_K:
        return topk_rows(x.contiguous(), k)
    return topk_rows_plain(x, k)
