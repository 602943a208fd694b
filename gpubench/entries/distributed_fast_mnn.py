"""The entry ``distributed_fast_mnn``: fastMNN's merge of PCs with the cells
split over the ranks of the program's world, one process a card
(``batchelor_torch/parallel/driver.py``). Every rank makes the same inputs
and calls the entry alike; each returns the whole result.

Inputs, output, judgement and control are ``fast_mnn``'s on PCs
(``"input": "pcs"``), read as ``reduced_mnn``'s are: no PCA, so no
``centers_err``; with two batches of equal size, ``rows_err_p50`` reads the
first batch, which is only centred, and ``batch_rows_err_p50`` the second,
which the merge corrects. ``bind`` makes the cells mesh once, at set-up.
Every rank judges: rank 0 with the kept outputs, the others sharing the
reference's searches (``harness.output_readings``).

The faults are planted on the distributed path itself, on every rank
(``gpubench/faults.py`` patches ``correct/fast_mnn.py``, which this path
does not call):

  * ``unchanged``: every merge step's tricube weights are zero, so the step
    returns the right batch centred but not corrected.
  * ``half_pairs``: each step's pairs of every other left cell (odd global
    row ids) are left out of the mutual mask, so the correction vectors
    are averaged over the other half.
  * ``sums_not_reduced``: the exchange between the cards left out: every
    sum of the step (pair counts and sums, the batch vector, the centring
    means, the variances) is this rank's own, not reduced over the ranks.
  * ``altered_row``: two corrected rows, in different batches, swap places
    where the walk hands them back.
"""
import contextlib
from unittest import mock

import torch

from gpubench import harness
from gpubench.entries.fast_mnn import control, judge, make_inputs, output  # noqa: F401

READINGS = ("pairs_miss", "rows_err_p50", "batch_rows_err_p50", "rows_err_max", "own_rows_err_p50")
FAULTS = ("unchanged", "half_pairs", "sums_not_reduced", "altered_row")

output_readings = harness.output_readings


def bind(cell, bt, device):
    """The call: ``distributed_fast_mnn`` on the mesh of this rank's
    world and ``device``, with the traffic's arguments."""
    mesh = bt.make_cells_mesh(device=device)
    kwargs = harness.call_args(cell)
    return lambda inputs: bt.distributed_fast_mnn(inputs, mesh, **kwargs)


@contextlib.contextmanager
def planted(name: str):
    from batchelor_torch.ops import merge_math
    from batchelor_torch.parallel import driver

    if name == "unchanged":
        def no_weights(dist_, ndist):
            return torch.zeros_like(dist_)
        patch = mock.patch.object(merge_math, "tricube_weights", no_weights)
    elif name == "half_pairs":
        mask = merge_math._mutual_mask

        def halved(*args):
            mutual, l2r = mask(*args)
            group = args[10] if len(args) > 10 else None
            ids = (merge_math.group_rank(group) * mutual.shape[0]
                   + torch.arange(mutual.shape[0], device=mutual.device))
            return mutual & (ids % 2 == 0)[:, None], l2r
        patch = mock.patch.object(merge_math, "_mutual_mask", halved)
    elif name == "sums_not_reduced":
        def own_only(x, group=None):
            return x
        patch = mock.patch.object(merge_math, "pmaybe", own_only)
    elif name == "altered_row":
        walk = driver.walk_merge_tree

        def swap(nodes, *args, **kwargs):
            j = int(nodes[0].n)
            corrected, origin, infos = walk(nodes, *args, **kwargs)
            rows = corrected[[0, j]].clone()
            corrected[[j, 0]] = rows
            return corrected, origin, infos
        patch = mock.patch.object(driver, "walk_merge_tree", swap)
    else:
        raise ValueError(f"unknown fault {name!r}")
    with patch:
        yield
