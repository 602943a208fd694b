"""The port's merge checkpoints against the JAX package's, on the CPU in fp64.

Mirrors the checkpoint cases of tests/test_io.py (PCA-stage round trip,
resume, auto-merge resume) on the port, and resumes in the port a store
that JAX's reduced_mnn wrote: the on-disk format is shared. A resumed run
equals the uninterrupted one within 1e-12 when the port wrote the store
(the coordinates are read back bit for bit), and within 1e-10 when JAX
wrote it.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from batchelor_torch import (MergeCheckpointer, fast_mnn, load_pca_stage, reduced_mnn,
                             save_pca_stage)
from batchelor_tpu.correct.fast_mnn import reduced_mnn as j_reduced_mnn
from batchelor_tpu.io.checkpoint import load_pca_stage as j_load_pca_stage

torch.set_num_threads(2)


def _three(rng, shifts=(0.0, 1.0, 2.0), d=12):
    return [rng.normal(size=(n, d)) + s for n, s in zip((80, 90, 70), shifts)]


def _interrupt_after(ck: str, steps: int) -> None:
    """Leave ``ck`` as a run stopped after ``steps`` merge steps leaves it:
    the later steps' files gone and the metadata counting ``steps``."""
    meta_path = os.path.join(ck, "merge_meta.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    for mdx in range(steps, meta["completed"]):
        os.remove(os.path.join(ck, f"step_{mdx:04d}.npz"))
        os.remove(os.path.join(ck, f"step_{mdx:04d}_data.npy"))
    meta["completed"] = steps
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)


def _same(a, b, atol):
    assert np.allclose(a.corrected.numpy(), b.corrected.numpy(), atol=atol, rtol=0)
    for x, y in zip(a.merge_info, b.merge_info):
        assert np.array_equal(x.pairs, y.pairs)
        assert np.allclose(x.lost_var, y.lost_var, atol=atol, rtol=0, equal_nan=True)
        assert abs(x.batch_size - y.batch_size) <= atol


def test_pca_stage_roundtrip_and_jax_reads_it(rng, tmp_path):
    comps = [torch.from_numpy(rng.normal(size=(10, 4))), rng.normal(size=(12, 4))]
    rot = torch.from_numpy(rng.normal(size=(20, 4)))
    cen = rng.normal(size=20)
    save_pca_stage(str(tmp_path / "pca"), comps, rot, cen, ["a", "b"])
    for back in (load_pca_stage(str(tmp_path / "pca")), j_load_pca_stage(str(tmp_path / "pca"))):
        c2, r2, cen2, names = back
        assert np.array_equal(np.asarray(r2), rot.numpy())
        assert np.array_equal(np.asarray(cen2), cen)
        assert names == ["a", "b"]
        for a, b in zip(comps, c2):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert load_pca_stage(str(tmp_path / "none")) is None


def test_merge_checkpoint_resume(rng, tmp_path):
    mats = _three(rng)
    ck = str(tmp_path / "merge")
    ref = reduced_mnn(mats, device="cpu")
    full = reduced_mnn(mats, checkpoint_dir=ck, device="cpu")
    _same(full, ref, 1e-12)
    assert MergeCheckpointer(ck).completed_steps == 2
    # resume: every step replayed from disk
    _same(reduced_mnn(mats, checkpoint_dir=ck, device="cpu"), ref, 1e-12)
    # a run stopped after its first step finishes the second
    _interrupt_after(ck, 1)
    _same(reduced_mnn(mats, checkpoint_dir=ck, device="cpu"), ref, 1e-12)
    assert MergeCheckpointer(ck).completed_steps == 2
    # a mismatched tree is detected
    with pytest.raises(ValueError, match="merge tree"):
        reduced_mnn(mats, merge_order=[2, 1, 0], checkpoint_dir=ck, device="cpu")


def test_merge_checkpoint_auto(rng, tmp_path):
    mats = [rng.normal(size=(60, 8)), rng.normal(size=(60, 8)) + 0.5,
            rng.normal(size=(80, 8)) + 0.6]
    ck = str(tmp_path / "auto")
    ref = reduced_mnn(mats, auto_merge=True, device="cpu")
    reduced_mnn(mats, auto_merge=True, checkpoint_dir=ck, device="cpu")
    _same(reduced_mnn(mats, auto_merge=True, checkpoint_dir=ck, device="cpu"), ref, 1e-12)
    _interrupt_after(ck, 1)
    _same(reduced_mnn(mats, auto_merge=True, checkpoint_dir=ck, device="cpu"), ref, 1e-12)


def test_fast_mnn_checkpoint_resume(rng, tmp_path):
    mats = [rng.poisson(3.0, size=(60, 30)).astype(np.float64) for _ in range(3)]
    ck = str(tmp_path / "fast")
    ref = fast_mnn(mats, d=5, device="cpu")
    fast_mnn(mats, d=5, checkpoint_dir=ck, device="cpu")
    _interrupt_after(ck, 1)
    _same(fast_mnn(mats, d=5, checkpoint_dir=ck, device="cpu"), ref, 1e-12)


def test_jax_written_checkpoint_resumes_in_the_port(rng, tmp_path):
    mats = _three(rng)
    ck = str(tmp_path / "jax")
    j_reduced_mnn([jnp.asarray(m) for m in mats], checkpoint_dir=ck)
    ref = reduced_mnn(mats, device="cpu")
    # every step from JAX's store, then JAX's first step and the port's second
    _same(reduced_mnn(mats, checkpoint_dir=ck, device="cpu"), ref, 1e-10)
    _interrupt_after(ck, 1)
    _same(reduced_mnn(mats, checkpoint_dir=ck, device="cpu"), ref, 1e-10)
