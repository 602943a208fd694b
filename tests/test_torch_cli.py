"""The port's command line (``python -m batchelor_torch``) against the JAX
package's (``python -m batchelor_tpu``), on the CPU.

Both CLIs run in this process through their ``main(argv)`` on the same
store, and once through ``python -m`` in a subprocess; the port's with
``--device cpu``, the JAX package's on the port's trend fit
(``jax_trend.py``). What is compared, and how closely:
  * ``import-dense`` writes byte-identical stores and ``info`` prints the
    same line;
  * ``quick-correct``: the same hvgs.npy, batch.npy and merge_info.json;
    corrected.npy and rotation.npy within 1e-4 of their max after turning
    each port column to the sign of JAX's, centers.npy within 1e-6 (fp32
    streams summed in other orders, as in tests/test_torch_io.py);
    metrics.json holds the ``quickcsr/*`` spans;
  * ``correct --method rescale --subset-hvgs``: corrected.npy within 1e-6
    of its max (fp32 values) and batch.npy equal;
  * without ``--device`` the port runs on CUDA and, with no card, raises.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from batchelor_torch import __main__ as tcli
from batchelor_tpu import __main__ as jcli
from jax_trend import port_trend_in_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_FILES = ("header.json", "data.f32", "indices.i32", "indptr.i64")


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(42)
    counts = [rng.poisson(4.0, size=(150, 80)).astype(np.float32),
              (rng.poisson(9.0, size=(120, 80)) * (rng.uniform(size=(120, 80)) < 0.7)
               ).astype(np.float32)]
    paths = {"port": [], "jax": []}
    for i, c in enumerate(counts):
        np.save(root / f"b{i}.npy", c)
        for name, main in (("port", tcli.main), ("jax", jcli.main)):
            dest = root / f"{name}_store{i}"
            _run(main, ["import-dense", str(root / f"b{i}.npy"), str(dest)])
            paths[name].append(str(dest))
    return root, paths


def test_import_dense_and_info_match_jax(stores):
    _, paths = stores
    for mine, theirs in zip(paths["port"], paths["jax"]):
        for f in STORE_FILES:
            with open(os.path.join(mine, f), "rb") as a, open(os.path.join(theirs, f), "rb") as b:
                assert a.read() == b.read(), f
        assert _run(tcli.main, ["info", mine]) == _run(jcli.main, ["info", theirs])


@pytest.fixture(scope="module")
def quick_outputs(stores):
    root, paths = stores
    args = ["--hvgs", "40", "--d", "8", "--k", "10", "--knn", "exact", "--block-rows", "64"]
    _run(tcli.main, ["quick-correct", "--input", *paths["port"], "--output",
                     str(root / "port_qc"), "--device", "cpu", *args])
    with port_trend_in_jax():
        _run(jcli.main, ["quick-correct", "--input", *paths["jax"], "--output",
                         str(root / "jax_qc"), *args])
    return root / "port_qc", root / "jax_qc"


def test_quick_correct_cli_matches_jax(quick_outputs):
    mine, theirs = quick_outputs
    for f in ("hvgs.npy", "batch.npy"):
        assert np.array_equal(np.load(mine / f), np.load(theirs / f)), f
    with open(mine / "merge_info.json") as a, open(theirs / "merge_info.json") as b:
        mi, ti = json.load(a), json.load(b)
    assert [{k: v for k, v in m.items() if k != "batch_size"} for m in mi] == [
        {k: v for k, v in t.items() if k != "batch_size"} for t in ti]
    assert np.allclose([m["batch_size"] for m in mi], [t["batch_size"] for t in ti], rtol=1e-5)
    rot, rot_j = np.load(mine / "rotation.npy"), np.load(theirs / "rotation.npy")
    sign = np.sign((rot * rot_j).sum(0))
    assert np.abs(rot * sign - rot_j).max() <= 1e-4 * np.abs(rot_j).max()
    cor, cor_j = np.load(mine / "corrected.npy"), np.load(theirs / "corrected.npy")
    assert cor.shape == (270, 8)
    assert np.abs(cor * sign - cor_j).max() <= 1e-4 * np.abs(cor_j).max()
    assert np.allclose(np.load(mine / "centers.npy"), np.load(theirs / "centers.npy"),
                       atol=1e-6)
    with open(mine / "metrics.json") as fh:
        spans = json.load(fh)["spans"]
    assert {"quickcsr/stats", "quickcsr/pca", "quickcsr/merge"} <= set(spans)


def test_correct_cli_matches_jax(stores):
    root, paths = stores
    args = ["--method", "rescale", "--subset-hvgs", "30"]
    _run(tcli.main, ["correct", "--input", *paths["port"], "--output", str(root / "port_c"),
                     "--device", "cpu", *args])
    with port_trend_in_jax():
        _run(jcli.main, ["correct", "--input", *paths["jax"], "--output", str(root / "jax_c"),
                         *args])
    got, want = np.load(root / "port_c" / "corrected.npy"), np.load(root / "jax_c" /
                                                                     "corrected.npy")
    assert got.shape == (270, 30)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.array_equal(np.load(root / "port_c" / "batch.npy"),
                          np.load(root / "jax_c" / "batch.npy"))
    assert (root / "port_c" / "metrics.json").exists()


def test_cli_defaults_to_cuda(stores, monkeypatch, tmp_path):
    _, paths = stores
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["quick-correct", "--hvgs", "10"], ["correct", "--method", "none"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _run(tcli.main, [*cmd, "--input", *paths["port"], "--output", str(tmp_path)])


def test_python_dash_m(stores):
    _, paths = stores
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "batchelor_torch", "info", paths["port"][1]],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout)
    assert info["cells"] == 120 and info["genes"] == 80 and not info["named_genes"]
    assert 0.6 < info["density"] < 0.8
