"""The port's CSR stores, block streamers, out-of-core PCA and
``quick_correct_csr`` against the JAX package's, on the CPU.

Covers tests/test_io.py except its two mesh cases (held against JAX in
tests/test_torch_parallel_outofcore.py) and its merge-checkpoint cases, which
tests/test_torch_checkpoint.py holds against JAX. Inputs are made with numpy
from a seed; both packages get the same arrays. What is compared, and how
closely:
  * stores: the files either package writes are byte-identical and each
    package loads the other's; densified blocks, subsets and row sums bit
    for bit;
  * ``device_dense_blocks`` bit for bit against the host densify and
    against JAX's, padded, unpadded and empty; ``multi_batch_pca_csr``, which
    always ships nonzeros, bit for bit against the same PCA on host-densified
    blocks, on a sparse and on a fully dense store (where JAX's "auto"
    densifies on the host);
  * ``multi_batch_pca_csr`` against JAX's (exact eigh, fewer than 1,024
    genes): centers within 1e-6, rotation and components within 1e-4 of
    their max after turning each port column to the sign of JAX's (both
    sides sum fp32 blocks, in different orders);
  * ``quick_correct_csr`` against JAX's: the same HVGs, identical pairs,
    corrected within 1e-4 of max |corrected| after sign alignment; and
    against the port's own dense pipeline on those HVGs (1e-4).
"""
import os
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import batchelor_torch as bt
import batchelor_tpu as bj
from batchelor_tpu.io import csr as jcsr
from batchelor_tpu.ops.pca_outofcore import multi_batch_pca_csr as j_pca_csr
from jax_trend import port_trend_in_jax

torch.set_num_threads(2)

FILES = ("header.json", "data.f32", "indices.i32", "indptr.i64")


def _sparse(rng, n, g, density=0.2):
    return ((rng.random((n, g)) < density) * rng.random((n, g))).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _signs(jax_cols, port_cols):
    return np.sign((np.asarray(jax_cols) * _np(port_cols)).sum(0))


def test_csr_roundtrip_and_cross_package_stores(rng, tmp_path):
    x = _sparse(rng, 100, 40)
    x[[3, 99]] = 0
    names = [f"g{i}" for i in range(40)]
    csr = bt.CSRCells.from_dense(x, gene_names=names)
    assert csr.shape == (100, 40)
    assert np.array_equal(csr.to_dense(), x)
    csr.save(str(tmp_path / "port"))
    jcsr.CSRCells.from_dense(x, gene_names=names).save(str(tmp_path / "jax"))
    for f in FILES:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    for mmap in (True, False):
        back = bt.CSRCells.load(str(tmp_path / "jax"), mmap=mmap)
        assert np.array_equal(back.to_dense(), x) and back.gene_names == names
        assert np.array_equal(back.row_sums(), csr.row_sums())
        theirs = jcsr.CSRCells.load(str(tmp_path / "port"), mmap=mmap)
        assert np.array_equal(theirs.to_dense(), x) and theirs.gene_names == names
    assert np.allclose(csr.row_sums(), x.sum(axis=1), atol=1e-4)
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "header.json").write_text('{"magic": "other"}')
    with pytest.raises(ValueError, match="not a batchelor CSR store"):
        bt.CSRCells.load(str(tmp_path / "bad"))


def test_csr_subsets(rng):
    x = _sparse(rng, 50, 30)
    csr = bt.CSRCells.from_dense(x, gene_names=[f"g{i}" for i in range(30)])
    jc = jcsr.CSRCells.from_dense(x, gene_names=[f"g{i}" for i in range(30)])
    genes = np.arange(0, 30, 3)
    sub = csr.select_genes(genes)
    assert np.array_equal(sub.to_dense(), x[:, genes])
    assert sub.gene_names == jc.select_genes(genes).gene_names
    cells = np.array([5, 1, 40, 7, 5])
    mine, theirs = csr.select_cells(cells), jc.select_cells(cells)
    assert np.array_equal(mine.to_dense(), x[cells])
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(mine, f), getattr(theirs, f)), f


def test_dense_blocks_padding(rng):
    x = _sparse(rng, 70, 10)
    csr = bt.CSRCells.from_dense(x)
    blocks = list(bt.dense_blocks(csr, block_rows=32))
    theirs = list(jcsr.dense_blocks(jcsr.CSRCells.from_dense(x), block_rows=32))
    assert [n for _, n in blocks] == [n for _, n in theirs] == [32, 32, 6]
    for (a, _), (b, _) in zip(blocks, theirs):
        assert a.shape == (32, 10) and np.array_equal(a, b)
    assert np.array_equal(np.concatenate([b[:n] for b, n in blocks]), x)


def test_pca_stage_roundtrip_across_packages(rng, tmp_path):
    from batchelor_tpu.io.checkpoint import load_pca_stage as j_load
    from batchelor_tpu.io.checkpoint import save_pca_stage as j_save

    comps = [rng.normal(size=(10, 4)), rng.normal(size=(12, 4))]
    rot, cen = rng.normal(size=(20, 4)), rng.normal(size=20)
    j_save(str(tmp_path / "jax"), comps, rot, cen, ["a", "b"])
    bt.save_pca_stage(str(tmp_path / "port"), [torch.from_numpy(c) for c in comps],
                      torch.from_numpy(rot), cen, ["a", "b"])
    for c2, r2, cen2, names in (bt.load_pca_stage(str(tmp_path / "jax")),
                                j_load(str(tmp_path / "port"))):
        assert np.array_equal(r2, rot) and np.array_equal(cen2, cen) and names == ["a", "b"]
        for a, b in zip(comps, c2):
            assert np.array_equal(a, b)


def test_device_dense_blocks_matches_host(rng):
    x = _sparse(rng, 70, 10)
    csr = bt.CSRCells.from_dense(x)
    host = list(bt.dense_blocks(csr, block_rows=32))
    dev = list(bt.device_dense_blocks(csr, block_rows=32, device="cpu"))
    theirs = list(jcsr.device_dense_blocks(jcsr.CSRCells.from_dense(x), block_rows=32))
    assert len(host) == len(dev) == len(theirs) == 3
    for (hb, hn), (db, dn), (jb, jn) in zip(host, dev, theirs):
        assert hn == dn == jn
        assert isinstance(db, torch.Tensor) and db.dtype == torch.float32
        assert tuple(db.shape) == hb.shape
        assert np.array_equal(db.numpy(), hb) and np.array_equal(db.numpy(), np.asarray(jb))
    last_b, last_n = list(bt.device_dense_blocks(csr, block_rows=32, pad=False,
                                                 device="cpu"))[-1]
    assert tuple(last_b.shape) == (6, 10) and last_n == 6
    assert np.array_equal(last_b.numpy(), x[64:])
    empty = bt.CSRCells.from_dense(np.zeros((5, 10), np.float32))
    blocks = list(bt.device_dense_blocks(empty, block_rows=8, device="cpu"))
    assert [(tuple(b.shape), n) for b, n in blocks] == [((8, 10), 5)]
    assert not blocks[0][0].any()


def test_device_dense_blocks_reads_a_mapped_store(rng, tmp_path):
    x = _sparse(rng, 40, 12)
    bt.CSRCells.from_dense(x).save(str(tmp_path / "s"))
    mapped = bt.CSRCells.load(str(tmp_path / "s"), mmap=True)
    assert isinstance(mapped.data, np.memmap)
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # no read-only-array warning
        got = torch.cat([b for b, _ in bt.device_dense_blocks(mapped, block_rows=16,
                                                              pad=False, device="cpu")])
    assert np.array_equal(got.numpy(), x)


@pytest.fixture(scope="module")
def pca_inputs():
    rng = np.random.default_rng(42)
    x1 = (_sparse(rng, 120, 40) * 3).astype(np.float32)
    x2 = (_sparse(rng, 90, 40) * 3).astype(np.float32)
    xd = rng.random((90, 40)).astype(np.float32)
    return x1, x2, xd


def test_outofcore_pca_matches_jax_and_dense(pca_inputs):
    x1, x2, _ = pca_inputs
    mine = bt.multi_batch_pca_csr([bt.CSRCells.from_dense(x1), bt.CSRCells.from_dense(x2)],
                                  d=6, block_rows=32, eig_method="exact", device="cpu")
    theirs = j_pca_csr([jcsr.CSRCells.from_dense(x1), jcsr.CSRCells.from_dense(x2)],
                       d=6, block_rows=32, eig_method="exact")
    assert all(isinstance(c, np.ndarray) for c in mine.components)
    assert np.allclose(mine.centers.numpy(), np.asarray(theirs.centers), atol=1e-6)
    sign = _signs(theirs.rotation, mine.rotation)
    rot = np.asarray(theirs.rotation)
    assert np.abs(mine.rotation.numpy() * sign - rot).max() <= 1e-4 * np.abs(rot).max()
    for a, b in zip(mine.components, theirs.components):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(a * sign - b).max() <= 1e-4 * np.abs(b).max()
    dense = bt.multi_batch_pca([x1, x2], d=6, device="cpu")
    sign = _signs(dense.rotation, mine.rotation)
    for a, b in zip(mine.components, dense.components):
        assert np.abs(a * sign - b.numpy()).max() <= 1e-4 * float(b.abs().max())


def _host_densify(csr, block_rows, pad=False, device=None):
    """The host-densify transfer: ``dense_blocks`` handed over as tensors."""
    for block, n_valid in bt.dense_blocks(csr, block_rows, pad=pad):
        yield torch.from_numpy(block), n_valid


def test_outofcore_pca_transfer_modes(pca_inputs, monkeypatch):
    # the port always ships nonzeros; its PCA is bit for bit the one it
    # computes from host-densified blocks, on a sparse and on a fully dense
    # store (JAX's "auto" densifies the latter on the host)
    from batchelor_torch.ops import pca_outofcore

    x1, x2, xd = pca_inputs
    kw = dict(d=6, block_rows=32, eig_method="exact", device="cpu")
    for x in ((x1, x2), (x1, xd)):
        csrs = [bt.CSRCells.from_dense(b) for b in x]
        sp = bt.multi_batch_pca_csr(csrs, **kw)
        with monkeypatch.context() as m:
            m.setattr(pca_outofcore, "device_dense_blocks", _host_densify)
            dn = bt.multi_batch_pca_csr(csrs, **kw)
        assert torch.equal(sp.centers, dn.centers) and torch.equal(sp.rotation, dn.rotation)
        for a, b in zip(sp.components, dn.components):
            assert np.array_equal(a, b)
    with pytest.raises(TypeError, match="transfer"):
        bt.multi_batch_pca_csr(csrs, d=6, transfer="dense", device="cpu")


@pytest.fixture(scope="module")
def qc_pair():
    rng = np.random.default_rng(42)
    c1 = rng.poisson(4.0, size=(150, 80)).astype(np.float32)
    c2 = rng.poisson(9.0, size=(120, 80)).astype(np.float32)
    kw = dict(hvg_n=40, d=8, k=10, block_rows=64, knn_method="exact")
    with port_trend_in_jax():
        theirs = bj.quick_correct_csr([jcsr.CSRCells.from_dense(c1),
                                       jcsr.CSRCells.from_dense(c2)], **kw)
    mine = bt.quick_correct_csr([bt.CSRCells.from_dense(c1), bt.CSRCells.from_dense(c2)],
                                device="cpu", **kw)
    return c1, c2, kw, theirs, mine


def test_quick_correct_csr_matches_jax(qc_pair):
    _, _, _, theirs, mine = qc_pair
    assert np.array_equal(mine.hvgs, theirs.hvgs)
    nhv = mine.hvgs.shape[0]
    assert 8 < nhv <= 40
    out, ref = mine.corrected, theirs.corrected
    assert tuple(out.corrected.shape) == (270, 8) and tuple(out.rotation.shape) == (nhv, 8)
    for f in ("mean", "total", "tech", "bio"):
        assert np.allclose(getattr(mine.dec, f), getattr(theirs.dec, f), rtol=1e-12, atol=0), f
    assert len(out.merge_info) == len(ref.merge_info)
    for a, b in zip(out.merge_info, ref.merge_info):
        assert np.array_equal(a.pairs, b.pairs)
        assert list(a.left) == list(b.left) and list(a.right) == list(b.right)
    sign = _signs(ref.rotation, out.rotation)
    want = np.asarray(ref.corrected)
    assert np.abs(out.corrected.numpy() * sign - want).max() <= 1e-4 * np.abs(want).max()
    assert np.allclose(out.centers.numpy(), np.asarray(ref.centers), atol=1e-6)
    assert np.array_equal(np.asarray(out.batch), np.asarray(ref.batch))


def test_quick_correct_csr_matches_dense_pipeline(qc_pair):
    c1, c2, _, _, mine = qc_pair
    from batchelor_torch.ops.cosine_norm import cosine_norm

    norm = bt.multi_batch_norm([c1, c2], device="cpu")
    hv = torch.from_numpy(mine.hvgs)
    cn = [cosine_norm(m[:, hv]) for m in norm.logcounts]
    pca = bt.multi_batch_pca(cn, d=8, device="cpu")
    ref = bt.reduced_mnn(pca.components, k=10, device="cpu")
    sign = _signs(pca.rotation, mine.corrected.rotation)
    want = ref.corrected.numpy()
    got = mine.corrected.corrected.numpy() * sign
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert [tuple(i.left) for i in mine.corrected.merge_info] == [
        tuple(i.left) for i in ref.merge_info]


def test_quick_correct_csr_pca_cache(qc_pair, tmp_path):
    c1, c2, kw, _, mine = qc_pair
    stores = [bt.CSRCells.from_dense(c1), bt.CSRCells.from_dense(c2)]
    first = bt.quick_correct_csr(stores, pca_cache_dir=str(tmp_path), device="cpu", **kw)
    assert (tmp_path / "pca_stage.npz").exists()
    again = bt.quick_correct_csr(stores, pca_cache_dir=str(tmp_path), device="cpu", **kw)
    for res in (first, again):
        assert torch.equal(res.corrected.corrected, mine.corrected.corrected)
        assert torch.equal(res.corrected.rotation, mine.corrected.rotation)


def test_quick_correct_csr_input_validation(rng):
    c1 = rng.poisson(4.0, size=(50, 30)).astype(np.float32)
    c2 = rng.poisson(4.0, size=(40, 25)).astype(np.float32)
    with pytest.raises(ValueError, match="number of features"):
        bt.quick_correct_csr([bt.CSRCells.from_dense(c1), bt.CSRCells.from_dense(c2)],
                             device="cpu")
    with pytest.raises(ValueError, match="two batches"):
        bt.quick_correct_csr([bt.CSRCells.from_dense(c1)], device="cpu")
    named = [bt.CSRCells.from_dense(c1, gene_names=[f"g{i}" for i in range(30)]),
             bt.CSRCells.from_dense(c1, gene_names=[f"h{i}" for i in range(30)])]
    with pytest.raises(ValueError, match="gene names differ"):
        bt.quick_correct_csr(named, device="cpu")
    zero = c1.copy()
    zero[3] = 0
    with pytest.raises(ValueError, match="positive library sizes"):
        bt.quick_correct_csr([bt.CSRCells.from_dense(zero), bt.CSRCells.from_dense(c1)],
                             device="cpu")
