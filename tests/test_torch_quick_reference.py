"""The port's quick_correct against the benchmark's plain reference
(``gpubench/quick_reference.py`` up to the HVGs, ``gpubench/reference.py``
for fastMNN) on the CPU in float64, at a small size: the size factors, the
variance decomposition, the HVGs, the MNN pairs, the corrected rows and
every gene's rotation agree, through the judgement the benchmark's
``quick_correct`` entry makes; a planted fault does not. The reference
loads neither JAX nor the port."""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import batchelor_torch as bt
from gpubench import harness, quick_reference

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ENTRY = harness.entry_module("quick_correct")
BATCHES = (600, 300, 450)
GENES = 400
D = 10


def _cell(hvg_n):
    config = json.loads((ROOT / "gpubench/configs/scib_immune_human_counts.json").read_text())
    config = copy.deepcopy(config)
    config.update(batches=list(BATCHES), genes=GENES, hvg_n=hvg_n, d=D)
    config["counts"]["bio_genes"] = 120
    return SimpleNamespace(config=config, limits=None)


@pytest.fixture(scope="module")
def counts():
    cfg = _cell(50).config
    return [c.double() for c in ENTRY.draw_counts(cfg, 2 ** 31 + 23, torch.device("cpu"))]


def _call(counts, hvg_n):
    res = bt.quick_correct(counts, hvg_n=hvg_n, params=bt.FastMNNParams(d=D), device="cpu")
    return ENTRY.output(res)


def _readings(cell, counts, out):
    model = quick_reference.variance_model(counts, float(cell.config["min_mean"]), int(cell.config["hvg_n"]))
    return ENTRY._readings(out, ENTRY._Reference(cell, counts, model)), model


@pytest.mark.parametrize("hvg_n", [50, 100])
def test_port_matches_the_plain_reference(counts, hvg_n):
    cell = _cell(hvg_n)
    got = bt.multi_batch_norm(counts, device="cpu").size_factors
    want = quick_reference.size_factors(counts, float(cell.config["min_mean"]))
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-12, atol=0)
    out = _call(counts, hvg_n)
    values, model = _readings(cell, counts, out)
    assert np.array_equal(out["hvgs"], model.hvgs) and out["hvgs"].shape == (hvg_n,)
    assert values["dec_err"] <= 1e-10 and values["hvg_miss"] == 0.0
    # the same pairs at every merge step, against the followed and the own merge
    assert values["pairs_miss"] == 0.0
    assert values["rows_err_max"] <= 1e-8 and values["own_rows_err_p50"] <= 1e-8
    assert values["centers_err"] <= 1e-10 and values["rotation_err"] <= 1e-8
    assert tuple(out["fastmnn"]["rotation"].shape) == (GENES, D)


def test_unrescaled_size_factors_fail_the_comparison(counts):
    cell = _cell(50)
    with ENTRY.planted("unrescaled_size_factors"):
        got = bt.multi_batch_norm(counts, device="cpu").size_factors
        out = _call(counts, 50)
    want = quick_reference.size_factors(counts, float(cell.config["min_mean"]))
    assert not all(torch.allclose(g, w, rtol=1e-12, atol=0) for g, w in zip(got, want))
    values, _ = _readings(cell, counts, out)
    assert values["dec_err"] > 1e-3


def test_the_reference_loads_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from gpubench import quick_reference, reference, compare, generator\n"
            "print(' '.join(sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = {m.split(".")[0] for m in out.stdout.split()}
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "batchelor_tpu", "batchelor_torch"}
