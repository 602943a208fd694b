"""The port's parallel layer (mesh, merge_math with a group, the distributed
merge step and PCA, the ring functions, multi-host start-up) against the JAX
package's, on the CPU in fp64.

Mirrors tests/test_distributed.py, test_ring.py and test_multihost.py case by
case. The port runs one process per rank: each world of W gloo ranks
(W = 1, 3 with uneven shards, 8; ``torch_worlds.run_world``) runs every case
once, from a module-scoped fixture, and sends numpy results back; the JAX
calls run in the parent process, on ``make_cells_mesh(W)`` of the conftest's 8 virtual
devices where the JAX test uses a mesh. Each case holds: pair counts and
neighbour indices identical, values within 1e-8 (the ring functions 1e-12),
PCA columns after turning each to the sign of JAX's, and every rank's
result identical to rank 0's. The world functions import no jax: this
module imports it only inside the tests.
"""
import numpy as np
import pytest
import torch

from torch_worlds import run_world

WORLDS = (1, 3, 8)
TARGET = "test_torch_parallel:parallel_cases"


def _inputs():
    rng = np.random.default_rng(42)
    n = rng.normal
    x = rng.normal(size=(97, 6))
    out = {
        # test_distributed.py's shapes
        "step_a": (n(size=(120, 16)), n(size=(200, 16)) + 1),
        "step_b": (n(size=(150, 12)), n(size=(130, 12)) + 0.5),
        "step_c": (n(size=(101, 8)), n(size=(77, 8)) + 1),
        "pca_a": [n(size=(90, 20)), n(size=(110, 20)) + 1],
        "pca_full": [n(size=(90, 24)), n(size=(110, 24)) + 1, n(size=(70, 24)) + 2],
        "pca_none": [n(size=(50, 12)), n(size=(60, 12)) + 1],
        # test_ring.py's shapes (fp32)
        "ring_q": n(size=(160, 12)).astype(np.float32),
        "ring_x": n(size=(320, 12)).astype(np.float32),
        "ring_mq": n(size=(80, 8)).astype(np.float32),
        "ring_mx": n(size=(240, 8)).astype(np.float32),
        # merge_math helpers and the other ring functions
        "x": x, "mask": rng.uniform(size=97) < 0.7,
        "origin": rng.integers(0, 3, 97), "v": n(size=6) / 2.0,
        "extras": np.stack([n(size=6), np.zeros(6), n(size=6)]),
        "l_rows": n(size=(41, 5)),
        "l2r": np.stack([rng.permutation(31)[:6] for _ in range(41)]),
        "r2l": np.stack([rng.permutation(41)[:4] for _ in range(31)]),
        "pair_mask": rng.uniform(size=(41, 6)) < 0.4,
        "table": n(size=(31, 5)),
        "widx": rng.integers(0, 31, size=(29, 7)),
        "w": rng.uniform(size=(29, 7)),
    }
    return out


# ----------------------------------------------------------------- worlds


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _pad_rows(a, w, value=0):
    n = a.shape[0]
    t = -(-n // w) * w
    pad = np.full((t - n,) + a.shape[1:], value, dtype=a.dtype)
    return np.concatenate([a, pad]), n


def _shard(mesh, a):
    s = a.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(a[mesh.rank * s:(mesh.rank + 1) * s]))


def parallel_cases(mesh, p):
    """Every case on one rank of a gloo world; numpy results."""
    import torch.distributed as dist

    from batchelor_torch.ops import merge_math as mm
    from batchelor_torch.parallel import (
        cells_sharding,
        distributed_merge_step,
        distributed_multi_batch_pca,
        initialize_multihost,
        make_cells_mesh,
        make_multihost_cells_mesh,
        pad_to_multiple,
        replicated_sharding,
        ring_membership,
        ring_query_knn_local,
        ring_segment_reduce,
        ring_weighted_gather,
    )

    g, w = mesh.group, mesh.size
    out = {}
    # the mesh helpers
    raised = []
    for call in (lambda: make_cells_mesh(w + 1, device="cpu"), lambda: make_cells_mesh()):
        try:
            call()
            raised.append(False)
        except (ValueError, RuntimeError):
            raised.append(True)
    local = make_cells_mesh(1, device="cpu")
    initialize_multihost()                       # already initialized: no-op
    mh = make_multihost_cells_mesh(device="cpu")
    xp, n = pad_to_multiple(torch.from_numpy(p["x"]), w)
    sh = cells_sharding(mesh)
    out["mesh"] = np.array([mesh.rank, mesh.size, dist.get_rank(), dist.get_world_size(),
                            mh.rank, mh.size, local.size, local.group is None, n, *raised])
    out["sharding"] = _np(sh.gather(sh.shard(xp)))
    out["replicated"] = _np(replicated_sharding(mesh).put(p["v"]))

    for name in ("step_a", "step_b", "step_c"):
        r = distributed_merge_step(*p[name], mesh)
        out[name] = {f: _np(getattr(r, f)) for f in r._fields}

    pca_kw = {"pca_a": dict(d=6),
              "pca_full": dict(d=5, weights=[[0, 1], 2], subset_row=np.arange(0, 24, 2),
                               get_all_genes=True, get_variance=True),
              "pca_none": dict(d=None, get_variance=True)}
    for name, kw in pca_kw.items():
        r = distributed_multi_batch_pca(p[name], mesh, **kw)
        out[name] = {"components": [_np(c) for c in r.components], "rotation": _np(r.rotation),
                     "centers": _np(r.centers), "var_explained": r.var_explained,
                     "var_total": r.var_total}

    # ring kNN, unmasked and masked (the data padded to a multiple of W;
    # the pads are masked rows)
    for name, q, x, k, nvalid in (("ring_knn", p["ring_q"], p["ring_x"], 9, 320),
                                  ("ring_knn_masked", p["ring_mq"], p["ring_mx"], 5, 190)):
        qp, nq = _pad_rows(q, w)
        xpad, _ = _pad_rows(x, w)
        valid = np.arange(xpad.shape[0]) < nvalid
        idx, dist_ = ring_query_knn_local(_shard(mesh, qp), _shard(mesh, xpad),
                                          _shard(mesh, valid), k, w, g)
        out[name] = (_np(mm.gmaybe(idx, g))[:nq], _np(mm.gmaybe(dist_, g))[:nq])

    # the other ring functions against the gathered tables: left rows and
    # right rows padded to multiples of W (padded l2r entries point nowhere)
    l2r, n1 = _pad_rows(p["l2r"], w, value=-1)
    r2l, _ = _pad_rows(p["r2l"], w, value=-1)
    mutual, _ = _pad_rows(p["pair_mask"], w, value=False)
    l_rows, _ = _pad_rows(p["l_rows"], w)
    table, _ = _pad_rows(p["table"], w)
    widx, n3 = _pad_rows(p["widx"], w)
    ww, _ = _pad_rows(p["w"], w)
    s2 = r2l.shape[0] // w
    nsl = l2r.shape[0] // w
    ids = torch.arange(mesh.rank * nsl, (mesh.rank + 1) * nsl)
    mem = ring_membership(_shard(mesh, l2r), _shard(mesh, r2l), ids, s2, w, g)
    lsums, counts = ring_segment_reduce(_shard(mesh, l_rows), _shard(mesh, l2r),
                                        _shard(mesh, mutual), s2, w, g)
    wg = ring_weighted_gather(_shard(mesh, widx), _shard(mesh, ww), _shard(mesh, table),
                              table.shape[0] // w, w, g)
    out["ring_membership"] = _np(mm.gmaybe(mem, g))[:n1]
    out["ring_segment_reduce"] = (_np(mm.gmaybe(lsums, g)), _np(mm.gmaybe(counts, g)))
    out["ring_weighted_gather"] = _np(mm.gmaybe(wg, g))[:n3]

    # merge_math with the group: the rows split, the statistics whole
    xm, nx = _pad_rows(p["x"], w)
    mk, _ = _pad_rows(p["mask"], w, value=False)
    org, _ = _pad_rows(p["origin"], w)
    vv = torch.from_numpy(p["v"])
    xs, ms, os_ = _shard(mesh, xm), _shard(mesh, mk), _shard(mesh, org)
    c, mean = mm.center_along(xs, ms, vv, g)
    out["center_along"] = (_np(mm.gmaybe(c, g))[:nx], _np(mean))
    out["replay_extras"] = _np(mm.gmaybe(mm.replay_extras(xs, ms, torch.from_numpy(p["extras"]),
                                                          g), g))[:nx]
    out["perbatch_var"] = _np(mm.perbatch_var(xs, os_, ms, 3, g))
    out["batch_vector_stats"] = tuple(_np(t) for t in mm.batch_vector_stats(xs, ms, g))
    out["pmaybe"] = _np(mm.pmaybe(torch.tensor([mesh.rank + 1.0]), g))
    if w == 1 and g is not None:
        # a group of one computes bit for bit what no group computes
        a, b = p["step_a"]
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ones_a, ones_b = torch.ones(len(a), dtype=torch.bool), torch.ones(len(b), dtype=torch.bool)
        org_a, org_b = torch.zeros(len(a), dtype=torch.long), torch.ones(len(b), dtype=torch.long)
        ex = torch.from_numpy(np.tile(p["extras"], (1, 3))[:, :a.shape[1]])
        both = []
        for group in (g, None):
            r = mm.merge_step_body(ta, tb, ones_a, ones_b, ones_a, ones_b, org_a, org_b,
                                   ex[:2], ex[1:], k1=20, k2=20, tricube_k=20, ndist=3.0,
                                   min_batch_skip=0.0, nb=2, group=group)
            both.append([_np(t) for t in r])
        out["group_of_one"] = both
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    return {w: run_world(w, TARGET, inputs, tmp) for w in WORLDS}


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if a is None or isinstance(a, (bool, int, float)):
        return a == b or (a != a and b != b)
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def _close(ours, theirs, atol=1e-8):
    assert np.allclose(np.asarray(ours), np.asarray(theirs), atol=atol, rtol=0)


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_returns_rank_zeros_result(worlds, w):
    ranks = worlds[w]
    for r in ranks[1:]:
        assert _tree_equal({k: v for k, v in ranks[0].items() if k != "mesh"},
                           {k: v for k, v in r.items() if k != "mesh"})
    for rank, res in enumerate(ranks):
        assert res["mesh"][0] == rank


@pytest.mark.parametrize("w", WORLDS)
def test_mesh_helpers(worlds, inputs, w):
    from batchelor_tpu.parallel.mesh import pad_to_multiple as j_pad

    res = worlds[w][0]
    rank, size, drank, dsize, mrank, msize, lsize, lnone, n, too_many, no_cuda = res["mesh"]
    assert (size, dsize, msize) == (w, w, w) and rank == drank == mrank
    assert lsize == 1 and bool(lnone) == (w > 1)    # a world of one keeps its group
    assert too_many and no_cuda            # no fallback to CPU devices; no card
    jp, jn = j_pad(inputs["x"], w)
    assert n == jn == 97
    assert np.array_equal(res["sharding"], np.asarray(jp))
    assert np.array_equal(res["replicated"], inputs["v"])


def test_mesh_without_a_group():
    from batchelor_torch.parallel import make_cells_mesh, pad_to_multiple

    mesh = make_cells_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert make_cells_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="requested 2 devices"):
        make_cells_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_cells_mesh()
    x = np.arange(10.0).reshape(5, 2)
    p, n = pad_to_multiple(torch.from_numpy(x), 4)
    assert n == 5 and p.shape == (8, 2) and float(p[5:].abs().sum()) == 0
    p2, n2 = pad_to_multiple(x, 5)
    assert n2 == 5 and p2 is x


@pytest.fixture(scope="module")
def jax_meshes():
    from batchelor_tpu.parallel.mesh import make_cells_mesh

    return {w: make_cells_mesh(w) for w in WORLDS}


def test_merge_step_sharding_equivalence(worlds, inputs, jax_meshes):
    import jax.numpy as jnp

    from batchelor_tpu.parallel.distributed import distributed_merge_step

    b1, b2 = (jnp.asarray(b) for b in inputs["step_a"])
    for w in WORLDS:
        ref = distributed_merge_step(b1, b2, jax_meshes[w])
        ours = worlds[w][0]["step_a"]
        assert int(ours["n_pairs"]) == int(ref.n_pairs)
        _close(ours["left"], ref.left)
        _close(ours["right"], ref.right)
        assert np.isclose(float(ours["batch_size"]), float(ref.batch_size), atol=1e-12)
    one, eight = worlds[1][0]["step_a"], worlds[8][0]["step_a"]
    assert np.allclose(one["left"], eight["left"], atol=1e-10)
    assert np.allclose(one["right"], eight["right"], atol=1e-10)


@pytest.mark.parametrize("name", ["step_b", "step_c"])
def test_merge_step_matches_fused_single_device(worlds, inputs, name):
    """step_c's sizes split unevenly over 3 and 8 ranks (the masked pads)."""
    import jax.numpy as jnp

    from batchelor_tpu.correct.fused import fused_merge_step

    b1, b2 = inputs[name]
    ref = fused_merge_step(jnp.asarray(b1), jnp.asarray(b2), 20, 20)
    for w in WORLDS:
        ours = worlds[w][0][name]
        assert ours["left"].shape == b1.shape and ours["right"].shape == b2.shape
        assert int(ours["n_pairs"]) == int(ref.n_pairs)
        _close(ours["left"], ref.left)
        _close(ours["right"], ref.right)


def _same_to_sign(ours, theirs, atol=1e-8):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    for j in range(ours.shape[1]):
        assert (np.allclose(ours[:, j], theirs[:, j], atol=atol, rtol=0)
                or np.allclose(ours[:, j], -theirs[:, j], atol=atol, rtol=0))


def test_distributed_pca_matches_local(worlds, inputs, jax_meshes):
    import jax.numpy as jnp

    from batchelor_tpu.ops.pca import multi_batch_pca
    from batchelor_tpu.parallel.distributed import distributed_multi_batch_pca

    mats = [jnp.asarray(m) for m in inputs["pca_a"]]
    ref = distributed_multi_batch_pca(mats, jax_meshes[8], d=6)
    host = multi_batch_pca(mats, d=6)
    for w in WORLDS:
        ours = worlds[w][0]["pca_a"]
        _close(ours["centers"], ref.centers, 1e-10)
        _close(ours["centers"], host.centers, 1e-10)
        for a, b in zip(ours["components"], ref.components):
            _same_to_sign(a, b)
        _same_to_sign(ours["rotation"], ref.rotation)


def test_distributed_pca_full_options(worlds, inputs, jax_meshes):
    """Weight trees, subset_row with get_all_genes, get_variance; the JAX
    oracle on 3 devices (uneven shards)."""
    import jax.numpy as jnp

    from batchelor_tpu.parallel.distributed import distributed_multi_batch_pca

    mats = [jnp.asarray(m) for m in inputs["pca_full"]]
    ref = distributed_multi_batch_pca(mats, jax_meshes[3], d=5, weights=[[0, 1], 2],
                                      subset_row=np.arange(0, 24, 2), get_all_genes=True,
                                      get_variance=True)
    for w in WORLDS:
        ours = worlds[w][0]["pca_full"]
        assert ours["rotation"].shape == (24, 5)
        _close(ours["centers"], ref.centers)
        for a, b in zip(ours["components"], ref.components):
            _same_to_sign(a, b)
        _same_to_sign(ours["rotation"], ref.rotation)
        _close(ours["var_explained"], ref.var_explained)
        assert np.isclose(ours["var_total"], ref.var_total, atol=1e-8, rtol=0)


def test_distributed_pca_d_none_passthrough(worlds, inputs):
    import jax.numpy as jnp

    from batchelor_tpu.ops.pca import multi_batch_pca

    ref = multi_batch_pca([jnp.asarray(m) for m in inputs["pca_none"]], d=None,
                          get_variance=True)
    for w in WORLDS:
        ours = worlds[w][0]["pca_none"]
        for a, b in zip(ours["components"], ref.components):
            _close(a, b, 1e-10)
        assert np.array_equal(ours["rotation"], np.asarray(ref.rotation))
        _close(ours["var_explained"], ref.var_explained)
        assert np.isclose(ours["var_total"], ref.var_total, atol=1e-8, rtol=0)


def _jax_ring(mesh, q, x, valid, k):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from batchelor_tpu.parallel.mesh import CELLS_AXIS, cells_sharding
    from batchelor_tpu.parallel.ring import ring_query_knn_local

    w = mesh.devices.size
    fn = jax.jit(jax.shard_map(
        lambda qs, xs, xv: ring_query_knn_local(qs, xs, xv, k, w), mesh=mesh,
        in_specs=(P(CELLS_AXIS, None), P(CELLS_AXIS, None), P(CELLS_AXIS)),
        out_specs=(P(CELLS_AXIS, None), P(CELLS_AXIS, None)), check_vma=False))
    sh = cells_sharding(mesh)
    idx, dist_ = fn(jax.device_put(jnp.asarray(q), sh), jax.device_put(jnp.asarray(x), sh),
                    jnp.asarray(valid))
    return np.asarray(idx), np.asarray(dist_)


@pytest.mark.parametrize("name,q,x,k,nvalid", [
    ("ring_knn", "ring_q", "ring_x", 9, 320),
    ("ring_knn_masked", "ring_mq", "ring_mx", 5, 190)])
def test_ring_knn_matches_allgather_and_jax_ring(worlds, inputs, jax_meshes, name, q, x, k,
                                                 nvalid):
    """Identical indices to the JAX ring on 8 and on 3 devices (its visiting
    order and tie rule) and to the all-gather search; distances 1e-5 (fp32)."""
    import jax.numpy as jnp

    from batchelor_tpu.ops.knn import query_knn

    qq, xx = inputs[q], inputs[x]
    ref = query_knn(jnp.asarray(qq), jnp.asarray(xx[:nvalid]), k)
    for w in WORLDS:
        idx, dist_ = worlds[w][0][name]
        assert np.array_equal(idx, np.asarray(ref.indices))
        assert np.allclose(dist_, np.asarray(ref.distances), atol=1e-5)
        if w > 1:
            qp, nq = _pad_rows(qq, w)
            xp, _ = _pad_rows(xx, w)
            j_idx, j_dist = _jax_ring(jax_meshes[w], qp, xp, np.arange(len(xp)) < nvalid, k)
            assert np.array_equal(idx, j_idx[:nq])
            assert np.allclose(dist_, j_dist[:nq], atol=1e-6)


@pytest.mark.parametrize("w", WORLDS)
def test_ring_membership_segment_reduce_weighted_gather(worlds, inputs, w):
    """Each ring function against the JAX package's whole-table computation
    on the same inputs (padded rows point nowhere and count nowhere)."""
    import jax.numpy as jnp

    from batchelor_tpu.ops.correction import pair_segment_sums
    from batchelor_tpu.ops.mutual_nn import membership_rows

    res = worlds[w][0]
    l2r, r2l = inputs["l2r"], inputs["r2l"]
    r2l_p, _ = _pad_rows(r2l, w, value=-1)
    mem = membership_rows(jnp.asarray(l2r), jnp.asarray(r2l_p), jnp.arange(len(l2r)))
    assert np.array_equal(res["ring_membership"], np.asarray(mem))
    n2 = r2l_p.shape[0]
    lsums, counts = pair_segment_sums(jnp.asarray(inputs["l_rows"]), jnp.asarray(l2r),
                                      jnp.asarray(inputs["pair_mask"]), n2)
    _close(res["ring_segment_reduce"][0], lsums, 1e-12)
    _close(res["ring_segment_reduce"][1], counts, 1e-12)
    table = inputs["table"]
    want = np.einsum("np,npd->nd", inputs["w"], table[inputs["widx"]])
    _close(res["ring_weighted_gather"], want, 1e-12)


@pytest.mark.parametrize("w", WORLDS)
def test_merge_math_with_a_group_matches_jax(worlds, inputs, w):
    """center_along, replay_extras, perbatch_var, batch_vector_stats and
    pmaybe over the ranks' row shards equal JAX's on the whole rows."""
    import jax.numpy as jnp

    from batchelor_tpu.ops import merge_math as j_mm

    res = worlds[w][0]
    x, mask, v = (jnp.asarray(inputs[k]) for k in ("x", "mask", "v"))
    c, mean = j_mm.center_along(x, mask, v)
    _close(res["center_along"][0], c, 1e-12)
    _close(res["center_along"][1], mean, 1e-12)
    _close(res["replay_extras"], j_mm.replay_extras(x, mask, jnp.asarray(inputs["extras"])),
           1e-12)
    _close(res["perbatch_var"], j_mm.perbatch_var(x, jnp.asarray(inputs["origin"]), mask, 3),
           1e-12)
    for a, b in zip(res["batch_vector_stats"], j_mm.batch_vector_stats(x, mask)):
        _close(a, b, 1e-12)
    assert float(res["pmaybe"][0]) == w * (w + 1) / 2


def test_group_of_one_is_bit_for_bit_no_group(worlds):
    """merge_step_body over a real gloo group of one rank gives bit for bit
    what it gives with group=None (which the fused step runs)."""
    with_group, without = worlds[1][0]["group_of_one"]
    assert len(with_group) == len(without) == 9
    for a, b in zip(with_group, without):
        assert np.array_equal(a, b)


def test_initialize_multihost_single_process_noop(monkeypatch):
    import torch.distributed as dist

    from batchelor_torch.parallel import initialize_multihost

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    initialize_multihost()
    assert not dist.is_initialized()


def test_initialize_multihost_explicit_config_fails_loudly():
    """A requested world that does not form raises instead of running 1/N of
    the job: rank 1 of 2 waits for a rank 0 that never comes (localhost)."""
    import socket

    import torch.distributed as dist

    from batchelor_torch.parallel import initialize_multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises((RuntimeError, ValueError)):
        initialize_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                             process_id=1, initialization_timeout=3)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        initialize_multihost(coordinator_address=f"127.0.0.1:{port}")


@pytest.mark.parametrize("w", WORLDS)
def test_multihost_mesh_spans_all_ranks_host_major(worlds, w):
    ranks = [r["mesh"] for r in worlds[w]]
    assert [m[4] for m in ranks] == list(range(w))      # rank order is host-major order
    assert all(m[5] == w for m in ranks)
