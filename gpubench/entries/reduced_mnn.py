"""The entry ``reduced_mnn``: fastMNN's merge on batches that are PCs
already (``"input": "pcs"``). Inputs, output, judgement, control and faults
are ``fast_mnn``'s; with no PCA in the call, no ``centers_err`` is read.
"""
from gpubench.entries.fast_mnn import FAULTS, control, judge, make_inputs, output, planted  # noqa: F401

READINGS = ("pairs_miss", "rows_err_p50", "batch_rows_err_p50", "rows_err_max", "own_rows_err_p50")
