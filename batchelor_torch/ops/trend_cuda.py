"""The trend fit's tricube smoother on the card: K6.

``local_linear(xs, ys, q, window)`` evaluates the tricube-weighted local
linear smoother of ``ys`` on the sorted ``xs`` at each query, as
``correct/diagnostics.py::_sorted_local_linear`` (the plain version, host
numpy) does, with ``csrc/trend_smooth.cu``: one warp a query over its
window, in float64, with no (queries x window) array in device memory.
``fit_trend_var`` takes it for moments that lie on the card (``takes``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["local_linear", "takes"]


def takes(device: torch.device) -> bool:
    """Whether the trend fit of tensors on ``device`` runs on the card (K6)."""
    return device.type == "cuda"


def _launcher():
    return _build.kernel_function(
        "trend_smooth", "trend_smooth_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    )


def local_linear(xs: torch.Tensor, ys: torch.Tensor, q: torch.Tensor, window: int) -> torch.Tensor:
    """The smoother of ``ys`` on ``xs`` (1-D float64, sorted by ``xs``) over
    windows of ``window`` points (2 <= window <= n), at each entry of ``q``:
    float64 of ``q``'s shape. On CPU tensors the plain version; on CUDA
    tensors K6 or raise."""
    n = xs.numel()
    if not 2 <= window <= n or ys.numel() != n:
        raise ValueError(f"local_linear takes n >= 2 points, as many ys, and a window of 2..n; "
                         f"got n={n}, {ys.numel()} ys, window={window}")
    if not takes(q.device):
        from ..correct.diagnostics import _sorted_local_linear

        fit = _sorted_local_linear(xs.numpy(), ys.numpy(), window)
        return torch.from_numpy(fit(q.reshape(-1).numpy())).reshape(q.shape)
    if (xs.dtype, ys.dtype, q.dtype) != (torch.float64,) * 3 or not (
            xs.device == ys.device == q.device):
        raise ValueError(f"local_linear takes float64 tensors on one device; got {xs.dtype} "
                         f"on {xs.device}, {ys.dtype} on {ys.device}, {q.dtype} on {q.device}")
    if n >= 2**31 or q.numel() >= 2**31:
        raise ValueError(f"local_linear takes sizes below 2^31, got {n} points, {q.numel()} queries")
    xs, ys = xs.contiguous(), ys.contiguous()
    qs, order = torch.sort(q.reshape(-1))
    out = torch.empty(q.numel(), dtype=torch.float64, device=q.device)
    if q.numel() == 0:
        return out.reshape(q.shape)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(xs.data_ptr(), ys.data_ptr(), n, window, qs.data_ptr(),
                          order.data_ptr(), q.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"trend_smooth kernel launch failed: cudaError {err}")
    local_linear.launches += 1
    return out.reshape(q.shape)


local_linear.launches = 0
