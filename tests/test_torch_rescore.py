"""Kernel K3's counterpart (the fused sub-chunk gather + rescore) on the CPU.

K3 is the DMA gather of benchmarks/knn_dma_rescore_probe.py, which copies
each query's selected (32, 64) sub-chunks into a contiguous buffer. The
port's ``gather_subchunks_plain`` is that contract and must equal the probe
kernel run in interpret mode bit for bit. ``rescore_subchunks_plain`` (the
gather + product that the CUDA kernel fuses) must match an fp64 numpy
rescore within 1e-6 of each row's largest |score|, and the two-pass kNN,
which now rescores through it, must still return JAX's indices.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchelor_torch.ops import knn_cuda, rescore_cuda
from batchelor_torch.ops.knn import query_knn as t_query_knn
from batchelor_tpu.ops.knn import query_knn as j_query_knn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "benchmarks", "knn_dma_rescore_probe.py")
K3_EMULATE = os.path.join(ROOT, "tools", "k3_emulate.py")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe():
    return _load("knn_dma_rescore_probe", PROBE)


def test_gather_plain_equals_probe_dma_gather(rng):
    probe = _probe()
    c32, qr, kc = 40, 16, 5
    data3 = rng.normal(size=(c32, probe.SUB, probe.DPAD)).astype(np.float32)
    ids = rng.integers(0, c32, size=(qr, kc)).astype(np.int32)
    want = np.asarray(probe.dma_gather(jnp.asarray(ids), jnp.asarray(data3).reshape(
        c32, probe.RS, probe.RL), kc, interpret=True))
    got = rescore_cuda.gather_subchunks_plain(torch.from_numpy(ids).long(),
                                              torch.from_numpy(data3)).numpy()
    assert want.shape == got.shape == (qr, kc, 32, 64)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("d", [7, 50])
def test_rescore_plain_matches_fp64(d, rng):
    nd, nq, ks = 900, 70, 6
    data = rng.normal(size=(nd, d)).astype(np.float32)
    valid = np.ones(nd, bool)
    valid[40:80] = False
    data3, dn2 = knn_cuda._chunked_view(torch.from_numpy(data), torch.from_numpy(valid))
    q = rng.normal(size=(nq, d)).astype(np.float32)
    ids = rng.integers(0, data3.shape[0], size=(nq, ks))
    ids[:, 0] = 1                                   # rows 40..63: masked
    got = rescore_cuda.rescore_subchunks(torch.from_numpy(q), data3, dn2,
                                         torch.from_numpy(ids)).numpy()
    x64 = data3.numpy().astype(np.float64)[ids]     # (nq, ks, 32, d)
    want = (2.0 * np.einsum("qksd,qd->qks", x64, q.astype(np.float64))
            - dn2.numpy().astype(np.float64)[ids]).reshape(nq, ks * 32)
    masked = np.isinf(want)
    assert masked.any() and np.array_equal(masked, np.isinf(got))
    assert (got[masked] < 0).all()
    scale = np.where(masked, 0.0, np.abs(want)).max(axis=1, keepdims=True)
    assert (np.abs(np.where(masked, 0.0, got) - np.where(masked, 0.0, want)) <= 1e-6 * scale).all()
    with pytest.raises(TypeError):
        rescore_cuda.rescore_subchunks(torch.from_numpy(q), data3, dn2,
                                       torch.from_numpy(ids).int())


@pytest.mark.parametrize("method", ["chunked", "bf16"])
def test_two_pass_knn_through_rescore_matches_jax(method, rng):
    """The rescore in several query tiles (a small max_bytes) still gives
    JAX's indices and distances."""
    q = rng.normal(size=(300, 12)).astype(np.float32)
    x = rng.normal(size=(3000, 12)).astype(np.float32)
    jr = j_query_knn(jnp.asarray(q), jnp.asarray(x), 10, method=method)
    tiles = 10 * 32 * 4 * 64                         # under 64 queries per rescore tile
    tr = t_query_knn(q, x, 10, method=method, device="cpu", max_bytes=tiles)
    assert np.array_equal(np.asarray(jr.indices), tr.indices.numpy())
    assert np.allclose(np.asarray(jr.distances), tr.distances.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("nq,ks,c32,d", [(300, 6, 900, 50), (200, 4, 400, 129), (200, 10, 2000, 7)])
def test_k3_emulation_matches_plain(nq, ks, c32, d, rng):
    """The kernel's algorithm on skewed ids: a hub bucket (every query's
    first id) of more than 3 items of 64 slots with masked rows, singleton
    and empty buckets, repeated ids within a row, counted by several CTAs.
    Every output row is written exactly once, and within 2^-20 of the row's
    max |score| of the plain version, with the same -inf entries."""
    emu = _load("k3_emulate", K3_EMULATE)
    q, data3, dn2, top_sub = emu.skewed_case(rng, nq, ks, c32, d)
    stats = emu.bucket_stats(top_sub, c32)
    assert stats["max"] > 3 * emu.P_DEFAULT and stats["unique"] < c32
    # counting CTAs of 256 slots split the count as the main path's 245 CTAs do
    out, writes, segments = emu.rescore(q, data3, dn2, top_sub, rng=rng, count_slots=256)
    assert (writes == 1).all()
    want = rescore_cuda.rescore_subchunks_plain(
        torch.from_numpy(q), torch.from_numpy(data3), torch.from_numpy(dn2),
        torch.from_numpy(top_sub)).numpy()
    masked = np.isinf(want)
    assert masked.any() and np.array_equal(masked, np.isinf(out)) and (out[masked] < 0).all()
    scale = np.where(masked, 0.0, np.abs(want)).max(axis=1, keepdims=True)
    diff = np.abs(np.where(masked, 0.0, out) - np.where(masked, 0.0, want))
    assert (diff <= 2.0 ** -20 * scale).all()
    assert segments.max() > 1 and segments.size == -(-nq * ks // emu.P_DEFAULT)
