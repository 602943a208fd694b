"""The port's distributed_fast_mnn against the JAX package's, on the CPU in
fp64.

Mirrors the semantic cases of tests/test_distributed_driver.py: three
batches, merge order with restrict, a merge tree, min_batch_skip, the ring
memory mode (against the gather mode and with restrict), lost variance in
both modes, auto_merge, checkpoint resume (a predefined tree and
auto_merge) and a mismatched tree. Not mirrored: the split and phased
steps (test_driver_multi_device_split_step_matches_composed,
test_driver_phased_step_matches_split), TPU workarounds the port does not
have; test_driver_one_device_plain_jit_matches_mesh becomes "no group
equals a world of 8". Also: ``pad_buckets`` changes nothing.

Each world of W gloo ranks (W = 1, 3, 8; ``torch_worlds.run_world``) runs
every case once; the JAX oracle is ``distributed_fast_mnn`` on
``make_cells_mesh(W)`` of the conftest's 8 virtual devices (the three-batch
case at every W, the others at 8), in its gather mode also for the port's
ring cases (JAX's own tests hold its ring to its gather mode; a JAX ring
call costs 40-75 s on an 8-core CPU, and the ring's tie order is held against JAX's in
tests/test_torch_parallel.py). Each case holds: pairs identical as sets
in every step, corrected values, batch sizes and lost variance within 1e-8,
the same batches and merge order, and every rank's result identical to rank
0's. The world functions import no jax: this module imports it only inside
the tests.
"""
import json
import os

import numpy as np
import pytest
import torch

from torch_worlds import run_world

WORLDS = (1, 3, 8)
TARGET = "test_torch_distributed_driver:driver_cases"


def _inputs():
    rng = np.random.default_rng(42)
    n = rng.normal
    return {
        "three": [n(size=(120, 14)), n(size=(150, 14)) + 1, n(size=(90, 14)) + 2],
        "order": [n(size=(100, 10)), n(size=(110, 10)) + 1, n(size=(95, 10)) + 2],
        "order_restrict": [np.arange(0, 100, 2), None, np.arange(50)],
        "tree": [n(size=(80, 8)) + i for i in range(4)],
        "skip": [n(size=(100, 10)), n(size=(100, 10))],
        "two_ring": [n(size=(96, 10)), n(size=(104, 10)) + 1],
        "auto": [n(size=(70, 10)), n(size=(170, 10)) + 0.3, n(size=(160, 10)) + 0.35],
        "ckpt": [n(size=(90, 10)), n(size=(100, 10)) + 1, n(size=(80, 10)) + 2,
                 n(size=(110, 10)) + 3],
        "mismatch": [n(size=(60, 8)), n(size=(70, 8)) + 1, n(size=(50, 8)) + 2],
        "auto_ckpt": [n(size=(70, 8)), n(size=(170, 8)) + 0.3, n(size=(160, 8)) + 0.35],
        "ring_restrict": [n(size=(100, 10)), n(size=(110, 10)) + 1],
        "small": [n(size=(90, 10)).astype(np.float32),
                  (n(size=(70, 10)) + 0.8).astype(np.float32)],
    }


# ----------------------------------------------------------------- worlds


def _result(res):
    return {"corrected": res.corrected.detach().cpu().numpy(), "batch": np.asarray(res.batch),
            "steps": [{"left": list(i.left), "right": list(i.right), "pairs": i.pairs,
                       "batch_size": float(i.batch_size), "skipped": bool(i.skipped),
                       "lost_var": np.asarray(i.lost_var)} for i in res.merge_info]}


def _rewind(mesh, ckdir, completed):
    """Rank 0 makes the store look as if the run stopped after ``completed``
    steps; every rank waits for it."""
    import torch.distributed as dist

    if mesh.rank == 0:
        meta_path = os.path.join(ckdir, "merge_meta.json")
        with open(meta_path) as fh:
            meta = json.load(fh)
        meta["completed"] = completed
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)
        for name in (f"step_{completed:04d}.npz", f"step_{completed:04d}_data.npy"):
            os.remove(os.path.join(ckdir, name))
    dist.barrier(mesh.group)


def driver_cases(mesh, p):
    """Every case on one rank of a gloo world; numpy results."""
    from batchelor_torch.parallel import distributed_fast_mnn as dfm
    from batchelor_torch.parallel import make_cells_mesh

    tmp = os.path.join(p["tmp"], f"w{mesh.size}")
    out = {
        "three": _result(dfm(p["three"], mesh)),
        "three_ring": _result(dfm(p["three"], mesh, memory="ring")),
        "three_buckets": _result(dfm(p["three"], mesh, pad_buckets=True)),
        "order": _result(dfm(p["order"], mesh, merge_order=[2, 0, 1],
                             restrict=p["order_restrict"])),
        "tree": _result(dfm(p["tree"], mesh, merge_order=[[0, 1], [2, 3]])),
        "skip": _result(dfm(p["skip"], mesh, min_batch_skip=0.5)),
        "two_ring": _result(dfm(p["two_ring"], mesh, memory="ring")),
        "auto": _result(dfm(p["auto"], mesh, auto_merge=True)),
        "ring_restrict": _result(dfm(p["ring_restrict"], mesh, memory="ring",
                                     restrict=[np.arange(0, 100, 2), None])),
        "small": _result(dfm(p["small"], mesh, k=10)),
    }
    try:
        dfm(p["auto"], mesh, auto_merge=True, merge_order=[0, 1, 2])
        out["auto_and_order_raises"] = False
    except ValueError:
        out["auto_and_order_raises"] = True
    if mesh.size == 1:
        # the same call without any process group
        out["small_no_group"] = _result(dfm(p["small"], make_cells_mesh(1, device="cpu"), k=10))

    # kill and resume: the steps before the "crash" come from the store
    full = dfm(p["ckpt"], mesh, checkpoint_dir=os.path.join(tmp, "full"))
    ck = os.path.join(tmp, "crash")
    dfm(p["ckpt"], mesh, checkpoint_dir=ck)
    _rewind(mesh, ck, 2)
    out["ckpt_full"] = _result(full)
    out["ckpt_resumed"] = _result(dfm(p["ckpt"], mesh, checkpoint_dir=ck))

    ck = os.path.join(tmp, "mismatch")
    dfm(p["mismatch"], mesh, checkpoint_dir=ck)
    try:
        dfm(p["mismatch"], mesh, merge_order=[2, 1, 0], checkpoint_dir=ck)
        out["mismatch"] = ""
    except ValueError as err:
        out["mismatch"] = str(err)

    ck = os.path.join(tmp, "auto")
    out["auto_ckpt_full"] = _result(dfm(p["auto_ckpt"], mesh, auto_merge=True,
                                        checkpoint_dir=ck))
    _rewind(mesh, ck, 1)
    out["auto_ckpt_resumed"] = _result(dfm(p["auto_ckpt"], mesh, auto_merge=True,
                                           checkpoint_dir=ck))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_driver")
    payload = dict(inputs, tmp=str(tmp))
    return {w: run_world(w, TARGET, payload, tmp) for w in WORLDS}


@pytest.fixture(scope="module")
def jax_meshes():
    from batchelor_tpu.parallel.mesh import make_cells_mesh

    return {w: make_cells_mesh(w) for w in WORLDS}


_JAX = {}


def _jax(inputs, jax_meshes, name, w, **kw):
    """JAX's distributed_fast_mnn on case ``name`` at W devices, once."""
    import jax.numpy as jnp

    from batchelor_tpu.parallel.driver import distributed_fast_mnn

    key = (name, w, repr(sorted(kw.items())))
    if key not in _JAX:
        _JAX[key] = distributed_fast_mnn([jnp.asarray(m) for m in inputs[name]],
                                         jax_meshes[w], **kw)
    return _JAX[key]


def _pair_set(p):
    return set(map(tuple, np.asarray(p).tolist()))


def _same(ours, ref, atol=1e-8):
    """ours: a world's result; ref: a JAX MNNResult."""
    assert np.allclose(ours["corrected"], np.asarray(ref.corrected), atol=atol, rtol=0)
    assert np.array_equal(ours["batch"], np.asarray(ref.batch))
    assert len(ours["steps"]) == len(ref.merge_info)
    for a, b in zip(ours["steps"], ref.merge_info):
        assert a["left"] == list(b.left) and a["right"] == list(b.right)
        assert _pair_set(a["pairs"]) == _pair_set(b.pairs)
        assert np.isclose(a["batch_size"], b.batch_size, atol=atol, rtol=0)
        assert a["skipped"] == bool(b.skipped)
        assert np.allclose(a["lost_var"], b.lost_var, atol=atol, rtol=0)


def _identical(a, b):
    assert np.array_equal(a["corrected"], b["corrected"])
    assert np.array_equal(a["batch"], b["batch"])
    for x, y in zip(a["steps"], b["steps"]):
        assert x["left"] == y["left"] and x["right"] == y["right"]
        assert np.array_equal(x["pairs"], y["pairs"])
        assert x["batch_size"] == y["batch_size"] and x["skipped"] == y["skipped"]
        assert np.array_equal(x["lost_var"], y["lost_var"])


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_returns_rank_zeros_result(worlds, w):
    for r in worlds[w][1:]:
        assert r.keys() == worlds[w][0].keys()
        for name, res in r.items():
            if isinstance(res, dict):
                _identical(worlds[w][0][name], res)
            else:
                assert res == worlds[w][0][name]


@pytest.mark.parametrize("w", WORLDS)
def test_driver_three_batches_matches_jax(worlds, inputs, jax_meshes, w):
    """Also lost variance (test_driver_lost_var_matches_host): positive for
    merged batches, zero for absent ones."""
    ref = _jax(inputs, jax_meshes, "three", w)
    ours = worlds[w][0]["three"]
    _same(ours, ref)
    assert ours["steps"][0]["lost_var"][0] > 0 and ours["steps"][0]["lost_var"][2] == 0.0


def test_driver_merge_order_and_restrict(worlds, inputs, jax_meshes):
    ref = _jax(inputs, jax_meshes, "order", 8, merge_order=[2, 0, 1],
               restrict=inputs["order_restrict"])
    for w in WORLDS:
        _same(worlds[w][0]["order"], ref)


def test_driver_tree_order(worlds, inputs, jax_meshes):
    ref = _jax(inputs, jax_meshes, "tree", 8, merge_order=[[0, 1], [2, 3]])
    for w in WORLDS:
        _same(worlds[w][0]["tree"], ref)


@pytest.mark.parametrize("w", WORLDS)
def test_driver_min_batch_skip(worlds, inputs, w):
    ours = worlds[w][0]["skip"]
    assert ours["steps"][0]["skipped"]
    assert np.allclose(ours["corrected"], np.concatenate(inputs["skip"]), atol=1e-10, rtol=0)


def test_driver_ring_memory_matches_gather_and_jax(worlds, inputs, jax_meshes):
    """memory='ring' reproduces the gather mode (pairs, values within 1e-8),
    the port's and JAX's on 8 devices."""
    ref = _jax(inputs, jax_meshes, "three", 8)
    for w in WORLDS:
        ring, gather = worlds[w][0]["three_ring"], worlds[w][0]["three"]
        _same(ring, ref)
        assert np.allclose(ring["corrected"], gather["corrected"], atol=1e-8, rtol=0)
        for a, b in zip(ring["steps"], gather["steps"]):
            assert _pair_set(a["pairs"]) == _pair_set(b["pairs"])
            assert np.isclose(a["batch_size"], b["batch_size"], atol=1e-8, rtol=0)


def test_driver_lost_var_ring(worlds, inputs, jax_meshes):
    ref = _jax(inputs, jax_meshes, "two_ring", 8)
    for w in WORLDS:
        _same(worlds[w][0]["two_ring"], ref)


def test_driver_auto_merge_matches_jax(worlds, inputs, jax_meshes):
    """auto_merge picks JAX's order and gives its coordinates; with a
    merge_order too it raises."""
    ref = _jax(inputs, jax_meshes, "auto", 8, auto_merge=True)
    for w in WORLDS:
        _same(worlds[w][0]["auto"], ref)
        assert worlds[w][0]["auto_and_order_raises"]


@pytest.mark.parametrize("w", WORLDS)
def test_driver_checkpoint_resume_bit_identical(worlds, w):
    """Kill and resume after step 2 of 3: bit for bit the uninterrupted run."""
    _identical(worlds[w][0]["ckpt_resumed"], worlds[w][0]["ckpt_full"])


@pytest.mark.parametrize("w", WORLDS)
def test_driver_checkpoint_rejects_mismatched_tree(worlds, w):
    assert "does not match" in worlds[w][0]["mismatch"]


@pytest.mark.parametrize("w", WORLDS)
def test_driver_auto_merge_checkpoint_resume(worlds, w):
    _identical(worlds[w][0]["auto_ckpt_resumed"], worlds[w][0]["auto_ckpt_full"])


def test_driver_ring_memory_restrict(worlds, inputs, jax_meshes):
    ref = _jax(inputs, jax_meshes, "ring_restrict", 8, restrict=[np.arange(0, 100, 2), None])
    for w in WORLDS:
        _same(worlds[w][0]["ring_restrict"], ref)


def test_driver_no_group_matches_a_world_of_eight(worlds):
    """The run without a process group (make_cells_mesh(1)) equals the world
    of 8 ranks: pairs identical, values within 1e-5 (fp32 inputs)."""
    one, eight = worlds[1][0]["small_no_group"], worlds[8][0]["small"]
    assert np.allclose(one["corrected"], eight["corrected"], atol=1e-5, rtol=0)
    assert _pair_set(one["steps"][0]["pairs"]) == _pair_set(eight["steps"][0]["pairs"])
    _identical(one, worlds[1][0]["small"])          # a gloo group of one: bit for bit


@pytest.mark.parametrize("w", WORLDS)
def test_pad_buckets_changes_nothing(worlds, w):
    _identical(worlds[w][0]["three_buckets"], worlds[w][0]["three"])


def test_unknown_memory_mode_and_single_batch_raise():
    from batchelor_torch.parallel import distributed_fast_mnn, make_cells_mesh

    mesh = make_cells_mesh(device="cpu")
    b = [np.zeros((5, 2)), np.ones((5, 2))]
    with pytest.raises(ValueError, match="memory mode"):
        distributed_fast_mnn(b, mesh, memory="sharded")
    with pytest.raises(ValueError, match="two batches"):
        distributed_fast_mnn(b[:1], mesh)
