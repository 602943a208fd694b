"""Kernel K4's counterpart (pass 1 with a separate norm vector) on the CPU.

K4 is make_kernel(precision) of benchmarks/knn_pass1_precision_probe.py.
The probe's own ``pass1`` has no interpret flag, so the test wraps the
probe's kernel in a pallas_call of its own, with the probe's block shapes
and interpret=True. ``pass1_scores_plain`` in each precision must agree
with it within 2^-20 of each query column's largest |score|, and a fully
masked sub-chunk must give -inf in both:
  * "highest" against Precision.HIGHEST;
  * "high3" against the probe's manual 3-pass arithmetic;
  * "bf16" against Precision.DEFAULT on operands rounded to bf16 first: on
    the CPU, DEFAULT is fp32, and a product of two bf16 values is exact in
    fp32, which reproduces the TPU's one bf16 pass.
The card's bf16 kernel returns the (N_d/32, N_q) view of a query-major
store; the probe path's selection must read that view as it reads the plain
version's contiguous result.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from batchelor_torch.ops import knn_cuda, pass1_cuda

torch.set_num_threads(2)

TOL = 2.0 ** -20
PROBE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "benchmarks", "knn_pass1_precision_probe.py")


def _probe():
    spec = importlib.util.spec_from_file_location("knn_pass1_precision_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_pass1(probe, q, x, dn, precision):
    """The probe's pass-1 kernel on prepared (q, x, dn), in interpret mode."""
    nqp, dpad = q.shape
    nd = x.shape[0]
    qt, dt, sub = probe.QT, probe.DT, probe.SUB
    return np.asarray(pl.pallas_call(
        probe.make_kernel(precision),
        grid=(nqp // qt, nd // dt),
        in_specs=[pl.BlockSpec((qt, dpad), lambda i, j: (i, 0)),
                  pl.BlockSpec((dt, dpad), lambda i, j: (j, 0)),
                  pl.BlockSpec((dt, 1), lambda i, j: (j, 0))],
        out_specs=pl.BlockSpec((dt // sub, qt), lambda i, j: (j, i)),
        out_shape=jax.ShapeDtypeStruct((nd // sub, nqp), jnp.float32),
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(x), jnp.asarray(dn)[:, None]))


@pytest.mark.parametrize("precision", ["highest", "high3", "bf16"])
def test_pass1_plain_matches_probe_kernel(precision, rng):
    probe = _probe()
    query = rng.normal(size=(500, 50)).astype(np.float32)
    data = (rng.normal(size=(2000, 50)) + 0.3).astype(np.float32)
    valid = np.ones(2000, bool)
    valid[100:200] = False                          # sub-chunks 4 and 5 fully masked
    q, x, dn = pass1_cuda.pass1_operands(torch.from_numpy(query), torch.from_numpy(data),
                                         torch.from_numpy(valid))
    assert q.shape == (512, 64) and x.shape == (2048, 64) and dn.shape == (2048,)
    if precision == "bf16":
        jq, jx = (t.to(torch.bfloat16).float().numpy() for t in (q, x))
        jprec = jax.lax.Precision.DEFAULT
    else:
        jq, jx = q.numpy(), x.numpy()
        jprec = jax.lax.Precision.HIGHEST if precision == "highest" else "high3"
    want = probe_pass1(probe, jq, jx, dn.numpy(), jprec)
    got = pass1_cuda.pass1_scores(q, x, dn, precision).numpy()
    assert want.shape == got.shape == (64, 512)
    masked = np.isneginf(want)
    assert masked[4:6].all() and np.array_equal(masked, np.isneginf(got))
    assert masked[63].all() and not masked[62].all()   # padding rows 2000..2047 are masked
    scale = np.where(masked, 0.0, np.abs(want)).max(axis=0, keepdims=True)
    assert (np.abs(np.where(masked, 0.0, got) - np.where(masked, 0.0, want)) <= TOL * scale).all()


def test_pass1_operands_follow_the_probe(rng):
    query = rng.normal(size=(10, 70)).astype(np.float32)
    data = rng.normal(size=(40, 70)).astype(np.float32)
    valid = np.ones(40, bool)
    valid[7] = False
    q, x, dn = pass1_cuda.pass1_operands(torch.from_numpy(query), torch.from_numpy(data),
                                         torch.from_numpy(valid))
    assert q.shape == (512, 128) and x.shape == (1024, 128)     # d > 64: a multiple of 128
    assert np.array_equal(q[:10, :70].numpy(), query) and not q[10:].any()
    want = np.square(data.astype(np.float64)).sum(1)
    assert np.allclose(dn[:40].numpy()[valid], want[valid], rtol=1e-6)
    assert torch.isinf(dn[7]) and torch.isinf(dn[40:]).all()
    with pytest.raises(ValueError):
        pass1_cuda.pass1_scores(q, x, dn, "medium")
    with pytest.raises(ValueError):
        pass1_cuda.pass1_scores(q[:100], x, dn)


@pytest.mark.parametrize("k", [1, 20])
def test_select_subchunks_reads_a_query_major_result_alike(k, rng):
    # On the card the bf16 kernel stores its maxima query-major and returns
    # the (N_d/32, N_q) view; the probe path's selection must give the same
    # sub-chunks from that view as from the plain version's contiguous result
    query = rng.normal(size=(300, 50)).astype(np.float32)
    data = (rng.normal(size=(3000, 50)) + 0.3).astype(np.float32)
    valid = np.ones(3000, bool)
    valid[100:200] = False
    q, x, dn = pass1_cuda.pass1_operands(torch.from_numpy(query), torch.from_numpy(data),
                                         torch.from_numpy(valid))
    plain = pass1_cuda.pass1_scores(q, x, dn, "bf16")
    view = plain.t().contiguous().t()               # the card's layout, the same values
    assert plain.is_contiguous() and view.t().is_contiguous()
    assert torch.equal(view, plain)
    want = knn_cuda._select_subchunks(plain, k)
    got = knn_cuda._select_subchunks(view, k)
    assert got.shape == (q.shape[0], k) and torch.equal(got, want)
