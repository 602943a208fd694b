"""The numbers that decide ``correct``: the program's output against the
reference's, on the same inputs.

PC coordinates are fixed only up to an orthogonal transform of the PC
space (the eigenvectors' signs, and rotations inside near-equal
eigenvalues), and every step of fastMNN commutes with such a transform.
So the reference's coordinates are first carried into the program's
basis by the orthogonal matrix nearest to ``ref_rotation.T @ rotation``;
what that cannot absorb, a different subspace, the rows' numbers read.

  * ``centers_err``: largest gap of the PCA's centering vector (the mean of
    the cosine-normalised cells), over the largest reference entry.
  * ``pairs_miss``: 1 - the Jaccard index of the program's and the
    reference's MNN pair sets, at the worst merge step.
  * ``rows_err_max``, ``rows_err_p50``: largest and median distance of a
    corrected row from the reference's, over the RMS spread of the
    reference's corrected rows around their mean.
  * ``batch_rows_err_p50``: the same distance's median over each batch's
    rows, at the worst batch. The first batch is only centred, never
    corrected; where it holds half of the rows, ``rows_err_p50`` reads it
    alone, and this reads the batches that the merge corrects.
  * ``own_rows_err_p50``: ``rows_err_p50`` against the reference's own
    merge, which chose every step's pairs itself (``own_readings``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["readings", "own_readings", "judge"]


def _pair_keys(pairs: np.ndarray, n: int) -> np.ndarray:
    p = np.asarray(pairs, dtype=np.int64)
    return np.unique(p[:, 0] * n + p[:, 1])


def _jaccard(a: np.ndarray, b: np.ndarray, n: int) -> float:
    ka, kb = _pair_keys(a, n), _pair_keys(b, n)
    inter = np.intersect1d(ka, kb, assume_unique=True).size
    union = ka.size + kb.size - inter
    return inter / union if union else 1.0


def readings(out: dict, ref: dict, sizes: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Each number of the program's output ``out`` against ``ref``. Both
    hold ``corrected`` and ``pairs``; with ``rotation`` and ``centers`` the
    PCA's numbers are read too, and with ``sizes``, the batches' rows in
    the output's order, ``batch_rows_err_p50``."""
    dev = ref["corrected"].device
    got = out["corrected"].to(dev, torch.float64)
    want = ref["corrected"].to(torch.float64)
    res: Dict[str, float] = {}
    if "rotation" in ref:
        r_ref = ref["rotation"].to(torch.float64)
        r_got = out["rotation"].to(dev, torch.float64)
        c_ref = ref["centers"].to(torch.float64)
        c_got = out["centers"].to(dev, torch.float64)
        res["centers_err"] = float((c_got - c_ref).abs().max() / c_ref.abs().max())
        u, _, vh = torch.linalg.svd(r_ref.T @ r_got)
        want = want @ (u @ vh)
    n = want.shape[0]
    if len(out["pairs"]) != len(ref["pairs"]):
        raise ValueError("the program and the reference made different numbers of merge steps")
    res["pairs_miss"] = 1.0 - min(_jaccard(a, b, n) for a, b in zip(out["pairs"], ref["pairs"]))
    spread = torch.sqrt(((want - want.mean(0)) ** 2).sum(1).mean())
    err = torch.sqrt(((got - want) ** 2).sum(1)) / spread
    res["rows_err_max"] = float(err.max())
    res["rows_err_p50"] = float(err.median())
    if sizes is not None:
        ends = np.cumsum(sizes)
        res["batch_rows_err_p50"] = max(float(err[lo:hi].median())
                                        for lo, hi in zip(ends - sizes, ends))
    return res


def own_readings(out: dict, own: dict) -> Dict[str, float]:
    """The number of ``out`` against the reference's own merge ``own``."""
    return {"own_rows_err_p50": readings(out, own)["rows_err_p50"]}


def judge(values: Dict[str, float], limits: Optional[Dict[str, float]]):
    """(correct, checks): every number that has a limit must be finite and
    at most its limit. ``checks`` maps each compared name to its value and
    limit. With no limits at all nothing is correct."""
    if not limits:
        return False, {}
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = values.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, checks
