"""The fastMNN merge step's reads of the device and the outcomes it hands
to the walk, on the CPU: one counted read a merge step
(``fastmnn/host_reads``), host diagnostics of the documented types once
the walk ends, and a resumed checkpoint that gives the uninterrupted
call's outputs bit for bit."""
import json
import os

import numpy as np
import pytest
import torch

import batchelor_torch as bt

torch.set_num_threads(2)

SIZES = (50, 40, 60, 45)


def _batches(width, seed=4):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(5, width))
    return [(base[rng.integers(0, 5, n)] + 0.3 * rng.normal(size=(n, width))
             + 0.5 * b * rng.normal(size=(1, width))).astype(np.float32)
            for b, n in enumerate(SIZES)]


def _call(entry, **kw):
    if entry == "fast_mnn":
        return bt.fast_mnn(_batches(30), k=5, d=6, device="cpu", **kw)
    return bt.reduced_mnn(_batches(6), k=5, device="cpu", **kw)


@pytest.mark.parametrize("entry", ["fast_mnn", "reduced_mnn"])
def test_merge_step_reads_the_device_once_a_step(entry):
    rec = bt.MetricsRecorder()
    with rec.activate():
        out = _call(entry)
    steps = len(SIZES) - 1
    assert rec.counters["merge_steps"] == steps
    assert rec.counters["fastmnn/host_reads"] == steps
    assert len(out.merge_info) == steps
    for info in out.merge_info:
        assert isinstance(info.pairs, np.ndarray) and info.pairs.dtype == np.int64
        assert info.pairs.ndim == 2 and info.pairs.shape[1] == 2 and len(info.pairs) > 0
        assert isinstance(info.lost_var, np.ndarray) and info.lost_var.dtype == np.float64
        assert info.lost_var.shape == (len(SIZES),)
        assert type(info.batch_size) is float
        assert type(info.skipped) is bool


@pytest.mark.parametrize("entry", ["fast_mnn", "reduced_mnn"])
def test_batch_skip_gate_reads_the_batch_size(entry):
    """``min_batch_skip`` decides on the host: a second read a step."""
    rec = bt.MetricsRecorder()
    with rec.activate():
        out = _call(entry, min_batch_skip=1e-6)
    assert rec.counters["fastmnn/host_reads"] == 2 * (len(SIZES) - 1)
    assert not any(info.skipped for info in out.merge_info)


def _interrupt_after(ck: str, steps: int) -> None:
    """Leave ``ck`` as a run stopped after ``steps`` merge steps leaves it."""
    meta_path = os.path.join(ck, "merge_meta.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    for mdx in range(steps, meta["completed"]):
        os.remove(os.path.join(ck, f"step_{mdx:04d}.npz"))
        os.remove(os.path.join(ck, f"step_{mdx:04d}_data.npy"))
    meta["completed"] = steps
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)


def _assert_identical(a, b):
    assert torch.equal(a.corrected, b.corrected)
    assert np.array_equal(a.batch, b.batch)
    for x, y in zip(a.merge_info, b.merge_info, strict=True):
        assert (x.left, x.right, x.skipped) == (y.left, y.right, y.skipped)
        assert np.array_equal(x.pairs, y.pairs) and x.pairs.dtype == y.pairs.dtype
        assert x.lost_var.tobytes() == y.lost_var.tobytes()
        assert x.batch_size == y.batch_size


@pytest.mark.parametrize("stored", [1, 2])
@pytest.mark.parametrize("entry", ["fast_mnn", "reduced_mnn"])
def test_checkpoint_resume_matches_the_uninterrupted_call(entry, stored, tmp_path):
    """A call resumed after ``stored`` of its 3 steps (a replayed node then
    merges on) gives the uninterrupted call's rows and diagnostics."""
    ck = str(tmp_path / "ck")
    ref = _call(entry)
    _assert_identical(_call(entry, checkpoint_dir=ck), ref)
    _interrupt_after(ck, stored)
    rec = bt.MetricsRecorder()
    with rec.activate():
        resumed = _call(entry, checkpoint_dir=ck)
    _assert_identical(resumed, ref)
    assert rec.counters["fastmnn/host_reads"] == len(SIZES) - 1 - stored
