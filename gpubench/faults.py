"""Faults planted in the program's timed path, to show that ``correct``
comes out false when the path is broken. Each is a context manager that
patches ``batchelor_torch.correct.fast_mnn`` while it is open.

  * ``unchanged``: every merge step returns the right batch's state
    unchanged (the tricube correction is skipped).
  * ``last_unchanged``: the last merge step alone returns it unchanged, so
    only the last batch (3% of the cells in ``scib_immune_human``) is off.
  * ``half_pairs``: the correction vectors are averaged over the first half
    of the MNN pairs only, the rest left out.
  * ``altered_row``: one answer altered where it is produced: two corrected
    rows, in different batches, swap places.

A cell on one card has no exchange between chips, so that fault has no
place here.
"""
from __future__ import annotations

import contextlib
from unittest import mock

__all__ = ["FAULTS", "planted"]

FAULTS = ("unchanged", "last_unchanged", "half_pairs", "altered_row")


@contextlib.contextmanager
def planted(name: str):
    from batchelor_torch.correct import fast_mnn as fm

    if name == "unchanged":
        def skip(curdata, correction, in_mnn, k=20, ndist=3.0):
            return curdata
        patch = mock.patch.object(fm, "tricube_weighted_correction", skip)
    elif name == "last_unchanged":
        core, tricube = fm._fast_mnn_core, fm.tricube_weighted_correction

        def last_skipped(batches, *args, **kwargs):
            steps_left = [len(batches) - 1]

            def correct(curdata, *a, **kw):
                steps_left[0] -= 1
                return curdata if steps_left[0] == 0 else tricube(curdata, *a, **kw)
            with mock.patch.object(fm, "tricube_weighted_correction", correct):
                return core(batches, *args, **kwargs)
        patch = mock.patch.object(fm, "_fast_mnn_core", last_skipped)
    elif name == "half_pairs":
        original = fm.average_correction

        def half(refdata, mnn1, curdata, mnn2):
            h = max(1, len(mnn1) // 2)
            return original(refdata, mnn1[:h], curdata, mnn2[:h])
        patch = mock.patch.object(fm, "average_correction", half)
    elif name == "altered_row":
        original = fm._fast_mnn_core

        def swap(batches, *args, **kwargs):
            out = original(batches, *args, **kwargs)
            i, j = 0, int(batches[0].shape[0])
            rows = out.corrected[[i, j]].clone()
            out.corrected[[j, i]] = rows
            return out
        patch = mock.patch.object(fm, "_fast_mnn_core", swap)
    else:
        raise ValueError(f"unknown fault {name!r}")
    with patch:
        yield
