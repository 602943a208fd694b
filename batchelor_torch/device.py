"""Device policy of the port: the card unless the caller asks for the CPU.

Every public entry point takes ``device=None``. ``None`` means ``cuda``; if
there is no CUDA device the call raises instead of running on the CPU. The
CPU runs only when asked for (``device="cpu"``), and there every kernel
wrapper uses its plain PyTorch version.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "full_fp32_matmul"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "batchelor_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (tensor or array-like) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if any(s < 0 for s in a.strides):       # a reversed view: torch takes no negative stride
        a = a.copy()
    return torch.as_tensor(a, device=device, dtype=dtype)


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 matrix products in full fp32 (no TF32) inside the block: every
    distance product needs it, as the reference's ``precision=HIGHEST``."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
