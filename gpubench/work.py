"""The least time of the MNN searches' score work in one fastMNN call.

This counts brute-force work: every query is scored against every data row
of its search. It depends on the batch sizes, the merge order (input
order), the PC width and k alone, so it reads the same whatever implements
the search. A search that prunes candidates does less work than this
counts; recounting for it is a change to the benchmark.

Each merge step m joins the first m + 1 batches (left, ``n_left`` cells)
with batch m + 1 (right, ``n_right``) and runs two searches: the left
cells' k nearest in the right batch, and the right cells' k nearest in the
left. A search of nq queries over nd rows of width d does nq * nd scores of
2 d flops; it reads both point sets once (float32) and writes k indices
(int64) and k distances (float32) a query. Its least time is the larger of
flops over the peak rate and bytes over the peak bandwidth; the call's is
the sum over its searches.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

__all__ = ["peaks", "searches", "search_least_seconds", "mnn_search_least_seconds"]

_IN_BYTES = 4               # float32 coordinates
_OUT_BYTES = 8 + 4          # an int64 index and a float32 distance


def peaks() -> Dict[str, float]:
    """The card's published peaks, ``gpubench/peaks.json``."""
    return json.loads(Path(__file__).with_name("peaks.json").read_text())


def searches(batch_sizes: Sequence[int]) -> Iterator[Tuple[int, int]]:
    """(queries, data rows) of each MNN search of an input-order merge."""
    n_left = int(batch_sizes[0])
    for n_right in batch_sizes[1:]:
        n_right = int(n_right)
        yield n_left, n_right
        yield n_right, n_left
        n_left += n_right


def search_least_seconds(nq: int, nd: int, d: int, k: int,
                         flops_per_s: float, bytes_per_s: float) -> float:
    flops = 2.0 * d * nq * nd
    nbytes = (nq + nd) * d * _IN_BYTES + nq * k * _OUT_BYTES
    return max(flops / flops_per_s, nbytes / bytes_per_s)


def mnn_search_least_seconds(batch_sizes: Sequence[int], d: int, k: int,
                             card: Optional[Dict[str, float]] = None) -> float:
    """Least seconds of one call's MNN searches on ``card`` (default: the
    peaks of ``peaks.json``)."""
    card = card or peaks()
    return sum(search_least_seconds(nq, nd, d, k, card["bf16_flops_per_s"],
                                    card["hbm_bytes_per_s"])
               for nq, nd in searches(batch_sizes))
