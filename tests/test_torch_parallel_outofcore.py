"""The ``mesh=`` arguments of the port's out-of-core engines against the
JAX package's, on the CPU.

Mirrors tests/test_io.py::test_device_dense_blocks_sharded_mesh and
::test_outofcore_pca_sparse_mesh_equality and
tests/test_sparse_gene_space.py::test_quick_correct_csr_mesh_matches_single.
Each world of W gloo ranks (W = 1, 3, 8; ``torch_worlds.run_world``) runs
every case once. What is held, and how closely:
  * ``device_dense_blocks(mesh=)``: each rank's rows of each block, stacked
    in rank order, bit for bit the host densify and JAX's sharded blocks
    (``block_rows`` rounded up to a multiple of W);
  * ``multi_batch_pca_csr(mesh=)``: bit for bit the run without a mesh over
    a gloo group of one; at every W, centers within 1e-6 and rotation and
    components within 1e-4 of their max (fp32 sums in other orders, after
    turning each column to the sign of the reference) of the port's run
    without a mesh and of JAX's on 8 devices;
  * ``quick_correct_csr(mesh=)``, gather and ring: the same HVGs, identical
    pairs and corrected values within 1e-4 of max |corrected| against the
    port's run without a mesh and JAX's on 8 devices.
Every rank's result is identical to rank 0's.
"""
import numpy as np
import pytest
import torch

from jax_trend import port_trend_in_jax
from torch_worlds import run_world

WORLDS = (1, 3, 8)
TARGET = "test_torch_parallel_outofcore:outofcore_cases"
QC = dict(hvg_n=30, d=8, k=10, block_rows=32)


def _sparse(rng, n, g):
    x = (rng.random((n, g)) < 0.2) * rng.random((n, g))
    return x.astype(np.float32)


def _inputs():
    rng = np.random.default_rng(42)
    counts1 = rng.poisson(4.0, size=(90, 50)).astype(np.float32) + (
        rng.uniform(size=(90, 50)) < 0.5).astype(np.float32)
    counts2 = 2.0 * rng.poisson(4.0, size=(110, 50)).astype(np.float32) + (
        rng.uniform(size=(110, 50)) < 0.5).astype(np.float32)
    return {"blocks": _sparse(rng, 70, 10),
            "pca": [(_sparse(rng, 120, 40) * 3).astype(np.float32),
                    (_sparse(rng, 88, 40) * 3).astype(np.float32)],
            "counts": [counts1, counts2]}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pca(res):
    return {"centers": _np(res.centers), "rotation": _np(res.rotation),
            "components": [_np(c) for c in res.components]}


def _qc(res):
    out = res.corrected
    return {"hvgs": np.asarray(res.hvgs), "corrected": _np(out.corrected),
            "rotation": _np(out.rotation), "batch": np.asarray(out.batch),
            "pairs": [np.asarray(i.pairs) for i in out.merge_info],
            "batch_size": [float(i.batch_size) for i in out.merge_info],
            "lost_var": [np.asarray(i.lost_var) for i in out.merge_info]}


def outofcore_cases(mesh, p):
    """Every case on one rank of a gloo world; numpy results."""
    from batchelor_torch import CSRCells, device_dense_blocks, multi_batch_pca_csr
    from batchelor_torch import quick_correct_csr

    csr = CSRCells.from_dense(p["blocks"])
    out = {"rank": mesh.rank}
    for name, rows, pad in (("blocks", 32, True), ("blocks_unpadded", 32, False),
                            ("blocks_30", 30, True)):
        out[name] = [(_np(b), n) for b, n in device_dense_blocks(csr, rows, pad, mesh=mesh)]
    csrs = [CSRCells.from_dense(x) for x in p["pca"]]
    kw = dict(d=6, block_rows=32, eig_method="exact")
    out["pca"] = _pca(multi_batch_pca_csr(csrs, mesh=mesh, **kw))
    if mesh.size == 1:
        out["pca_no_mesh"] = _pca(multi_batch_pca_csr(csrs, device="cpu", **kw))
    stores = [CSRCells.from_dense(c) for c in p["counts"]]
    out["qc"] = _qc(quick_correct_csr(stores, mesh=mesh, **QC))
    out["qc_ring"] = _qc(quick_correct_csr(stores, mesh=mesh, memory="ring", **QC))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_ooc")
    return {w: run_world(w, TARGET, inputs, tmp) for w in WORLDS}


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _signs(ref_rot, rot):
    """+-1 a column turning ``rot`` to the sign of ``ref_rot``."""
    return np.sign(np.sum(np.asarray(ref_rot) * np.asarray(rot), axis=0))


def _pca_close(ours, ref):
    assert np.allclose(ours["centers"], np.asarray(ref["centers"]), atol=1e-6, rtol=0)
    s = _signs(ref["rotation"], ours["rotation"])
    rot = np.asarray(ref["rotation"])
    assert np.abs(ours["rotation"] * s - rot).max() <= 1e-4 * np.abs(rot).max()
    for a, b in zip(ours["components"], ref["components"]):
        b = np.asarray(b)
        assert np.abs(a * s - b).max() <= 1e-4 * np.abs(b).max()


def _pair_set(p):
    return set(map(tuple, np.asarray(p).tolist()))


def _qc_close(ours, ref):
    assert np.array_equal(ours["hvgs"], ref["hvgs"])
    assert np.array_equal(ours["batch"], ref["batch"])
    assert len(ours["pairs"]) == len(ref["pairs"])
    for a, b in zip(ours["pairs"], ref["pairs"]):
        assert _pair_set(a) == _pair_set(b)
    s = _signs(ref["rotation"], ours["rotation"])
    want = np.asarray(ref["corrected"])
    assert np.abs(ours["corrected"] * s - want).max() <= 1e-4 * np.abs(want).max()
    assert np.allclose(ours["batch_size"], ref["batch_size"], atol=1e-5, rtol=0)
    for a, b in zip(ours["lost_var"], ref["lost_var"]):
        assert np.allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_returns_rank_zeros_result(worlds, w):
    ranks = worlds[w]
    assert [r["rank"] for r in ranks] == list(range(w))
    for r in ranks[1:]:
        for key in ("pca", "qc", "qc_ring"):
            assert _tree_equal(ranks[0][key], r[key])


@pytest.mark.parametrize("w", WORLDS)
def test_device_dense_blocks_split_over_the_mesh(worlds, inputs, w):
    """Each rank densifies only its rows of each block; stacked in rank order
    they are the host densify and JAX's sharded block, bit for bit."""
    from batchelor_torch import CSRCells, dense_blocks
    from batchelor_tpu.io import csr as jcsr
    from batchelor_tpu.parallel.mesh import make_cells_mesh

    x = inputs["blocks"]
    csr = CSRCells.from_dense(x)
    ranks = worlds[w]
    jax_mesh = make_cells_mesh(w)
    for name, rows in (("blocks", 32), ("blocks_30", 30)):
        rounded = -(-rows // w) * w
        host = list(dense_blocks(csr, rounded))
        theirs = list(jcsr.device_dense_blocks(jcsr.CSRCells.from_dense(x), block_rows=rows,
                                               mesh=jax_mesh))
        assert len(host) == len(theirs) == len(ranks[0][name])
        for i, ((hb, hn), (jb, jn)) in enumerate(zip(host, theirs)):
            stacked = np.concatenate([r[name][i][0] for r in ranks])
            assert stacked.shape == (rounded, x.shape[1]) and stacked.shape[0] % w == 0
            assert np.array_equal(stacked, hb) and np.array_equal(stacked, np.asarray(jb))
            assert sum(r[name][i][1] for r in ranks) == hn == jn
    unpadded = np.concatenate([b for i in range(len(ranks[0]["blocks_unpadded"]))
                               for r in ranks for b, _ in [r["blocks_unpadded"][i]]])
    assert np.array_equal(unpadded, x)


def test_outofcore_pca_mesh_matches_single_and_jax(worlds, inputs):
    from batchelor_torch import CSRCells, multi_batch_pca_csr
    from batchelor_tpu.io import csr as jcsr
    from batchelor_tpu.ops.pca_outofcore import multi_batch_pca_csr as j_pca_csr
    from batchelor_tpu.parallel.mesh import make_cells_mesh

    kw = dict(d=6, block_rows=32, eig_method="exact")
    single = _pca(multi_batch_pca_csr([CSRCells.from_dense(x) for x in inputs["pca"]],
                                      device="cpu", **kw))
    theirs = j_pca_csr([jcsr.CSRCells.from_dense(x) for x in inputs["pca"]],
                       transfer="sparse", mesh=make_cells_mesh(8), **kw)
    theirs = {"centers": np.asarray(theirs.centers), "rotation": np.asarray(theirs.rotation),
              "components": [np.asarray(c) for c in theirs.components]}
    assert _tree_equal(worlds[1][0]["pca"], worlds[1][0]["pca_no_mesh"])
    for w in WORLDS:
        _pca_close(worlds[w][0]["pca"], single)
        _pca_close(worlds[w][0]["pca"], theirs)


def test_quick_correct_csr_mesh_matches_single_and_jax(worlds, inputs):
    """Gather and ring against the run without a mesh and JAX's mesh run."""
    import batchelor_tpu as bj
    from batchelor_torch import CSRCells, quick_correct_csr
    from batchelor_tpu.io import csr as jcsr
    from batchelor_tpu.parallel.mesh import make_cells_mesh

    single = _qc(quick_correct_csr([CSRCells.from_dense(c) for c in inputs["counts"]],
                                   device="cpu", **QC))
    with port_trend_in_jax():
        theirs = bj.quick_correct_csr([jcsr.CSRCells.from_dense(c) for c in inputs["counts"]],
                                      mesh=make_cells_mesh(8), **QC)
    theirs = {"hvgs": np.asarray(theirs.hvgs),
              "corrected": np.asarray(theirs.corrected.corrected),
              "rotation": np.asarray(theirs.corrected.rotation),
              "batch": np.asarray(theirs.corrected.batch),
              "pairs": [np.asarray(i.pairs) for i in theirs.corrected.merge_info],
              "batch_size": [float(i.batch_size) for i in theirs.corrected.merge_info],
              "lost_var": [np.asarray(i.lost_var) for i in theirs.corrected.merge_info]}
    for w in WORLDS:
        for mode in ("qc", "qc_ring"):
            _qc_close(worlds[w][0][mode], single)
            _qc_close(worlds[w][0][mode], theirs)
