"""Batches of cells made on the device from a seed: the benchmark's one data
generator, driven by a configuration's ``generator`` block.

Every batch holds the same cell types; each batch draws its own type
proportions (Dirichlet(1), as normalised exponentials), its own shift (the
batch effect) and its own noise. Real donors of one tissue share their cell
types, and so mutual nearest neighbours between batches are plentiful.
Batches with no shared types (each batch drawing its type means anew, as an
earlier simulation of this repository did) leave few pairs, all at the
edges of clusters, and put them on a knife edge: moving the inputs by one
ulp then moved 99.4% of the corrected rows by more than 1e-4, which no
comparison with a reference can tell from a fault.

The biology lives in ``rank`` dimensions: type means, within-type variation
and batch shifts all lie in the span of ``rank`` orthonormal loadings, with
per-dimension scales ``decay ** j``, so the spectrum falls smoothly (about
ten effective dimensions at decay 0.93) and stays well above the noise up
to the last of the ``rank`` dimensions. With ``rank`` equal to the PCA's
``d`` the top-d subspace has a clear gap to the noise, so the PCA's subspace
is well determined and two exact implementations can be compared. Gene
space is ``biology @ loadings + noise``; PC space is ``biology + noise``.
Values are not held non-negative: nothing downstream needs it.

The same seed gives the same batches: one ``torch.Generator`` on the device,
drawn from in a fixed order, a few large calls per batch.
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["make_batches"]


def _scales(rank: int, decay: float, device) -> torch.Tensor:
    return decay ** torch.arange(rank, device=device, dtype=torch.float32)


def make_batches(config: dict, space: str, seed: int, device) -> List[torch.Tensor]:
    """The configuration's batches, fp32 on ``device``, cells in rows.

    ``space`` is ``"genes"`` (``config["genes"]`` columns) or ``"pcs"``
    (``config["generator"]["rank"]`` columns)."""
    gen_cfg = config["generator"]
    rank = int(gen_cfg["rank"])
    n_types = int(gen_cfg["types"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    scale = _scales(rank, float(gen_cfg["decay"]), device)
    means = torch.randn((n_types, rank), generator=g, device=device) * scale * float(gen_cfg["type_spread"])
    if space == "genes":
        width = int(config["genes"])
        raw = torch.randn((width, rank), generator=g, device=device)
        loadings = torch.linalg.qr(raw)[0].T.contiguous()       # (rank, genes), orthonormal rows
    elif space == "pcs":
        width, loadings = rank, None
    else:
        raise ValueError(f"unknown input space {space!r}")
    batches = []
    for n in config["batches"]:
        n = int(n)
        weights = -torch.log(torch.rand(n_types, generator=g, device=device))
        types = torch.multinomial(weights / weights.sum(), n, replacement=True, generator=g)
        shift = torch.randn(rank, generator=g, device=device) * scale * float(gen_cfg["batch_shift"])
        within = torch.randn((n, rank), generator=g, device=device) * scale * float(gen_cfg["within_spread"])
        biology = means[types] + shift + within
        x = biology if loadings is None else biology @ loadings
        x += torch.randn((n, width), generator=g, device=device) * float(gen_cfg["noise"])
        batches.append(x)
    return batches
