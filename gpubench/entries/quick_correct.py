"""The entry ``quick_correct``: batchelor's quickCorrect from raw counts.

Inputs: Poisson counts drawn on the device from the seed (``draw_counts``),
one fp32 tensor a batch. Judged of a call: the combined variance
decomposition (``dec``: ``mean``, ``total``, ``tech``, ``bio``), the HVGs
and fastMNN's output on them (``harness.program_output``), against the
plain float64 reference (``gpubench/quick_reference.py`` up to the HVGs,
``gpubench/reference.py`` for fastMNN), computed in blocks on the device:

  * ``dec_err``: the largest gap of any gene's ``mean``, ``total``, ``tech``
    or ``bio`` from the reference's, each field over the RMS of its
    reference. The means and totals are of the normalized log-counts, so
    this reading judges the size factors too.
  * ``hvg_miss``: 1 - the Jaccard index of the HVG sets.
  * ``hvg_count_err``: |the call's number of HVGs - ``hvg_n``| / ``hvg_n``;
    its limit is 0, so a call that runs fastMNN on fewer genes than the
    configuration states fails, whatever the reference chose.
  * ``centers_err``, ``pairs_miss``, ``rows_err_p50``, ``rows_err_max``
    (``gpubench/compare.py``): against the reference's fastMNN on the
    program's HVGs, its merge following the call's pairs, as
    ``harness.judge_outputs`` does; ``centers_err`` over every gene.
  * ``own_rows_err_p50``: against the reference's own HVGs, PCA and merge.
  * ``rotation_err``: the rotation of every gene against the reference's
    (``quick_reference.all_gene_rotation``) made from the call's own
    rotation of the HVGs, as the merge above follows the call's pairs: the
    largest gap over the RMS of the reference's entries. It reads the
    all-gene projection; the HVGs' subspace is read by the rows' numbers,
    since where the d-th and (d+1)-th eigenvalues nearly meet the d-th
    component turns out of the reference's subspace at fp32 (some seeds
    of this cell), and no alignment of the two bases can absorb that.

The control is the reference one precision below: log-counts rounded to
bf16 before the moments, the trend fit in fp32, fastMNN's products in
TF32. The faults: the size factors left unrescaled across batches, the
HVGs ranked by ``total`` instead of ``bio``, the trend without its
parametric curve, the trend's smoothed log-ratio floored at 0 (so the
trend never falls below its curve, as scran's may), and
``gpubench/faults.py``'s ``half_pairs``.
"""
import contextlib
import hashlib
import math
from unittest import mock

import numpy as np
import torch

from gpubench import compare, faults, generator, harness, quick_reference, reference

READINGS = ("dec_err", "hvg_miss", "hvg_count_err", "centers_err", "pairs_miss",
            "rows_err_p50", "rows_err_max", "own_rows_err_p50", "rotation_err")
FAULTS = ("unrescaled_size_factors", "hvgs_by_total", "trend_without_curve", "floored_trend",
          "half_pairs")
FIELDS = quick_reference.FIELDS


def draw_counts(config: dict, seed: int, device):
    """Poisson counts of each batch, fp32 on ``device``, cells in rows.

    The rate of gene g in cell c is L_c p_g exp(s x_cg): L_c the cell's
    library size (log-normal around ``library_median`` times its batch's
    depth factor), p_g the gene's share of the library (log-normal
    baseline abundances, normalised to sum to 1), and x the generator's
    log-expression (``generator.make_batches`` in ``bio_genes`` columns,
    its cell types, batch shifts and noise) on ``bio_genes`` genes placed
    at random, scaled by s = ``bio_scale``; x is 0 on the other genes. The
    same seed gives the same counts."""
    c = config["counts"]
    genes, n_bio = int(config["genes"]), int(c["bio_genes"])
    logexpr = generator.make_batches({**config, "genes": n_bio}, "genes", seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + (1 << 40))        # a stream apart from the generator's
    share = torch.exp(float(c["gene_meanlog"])
                      + float(c["gene_sdlog"]) * torch.randn(genes, generator=g, device=device))
    share /= share.sum()
    bio = torch.randperm(genes, generator=g, device=device)[:n_bio]
    depth = torch.exp(float(c["batch_depth_sdlog"])
                      * torch.randn(len(logexpr), generator=g, device=device))
    out = []
    for b, x in enumerate(logexpr):
        lib = float(c["library_median"]) * depth[b] * torch.exp(
            float(c["library_sdlog"]) * torch.randn(x.shape[0], generator=g, device=device))
        rate = lib[:, None] * share[None, :]
        rate[:, bio] *= torch.exp(float(c["bio_scale"]) * x)
        out.append(torch.poisson(rate, generator=g))
        del rate
    return out


def make_inputs(cell, seed: int, device):
    return draw_counts(cell.config, seed, device)


def output(result) -> dict:
    return {"dec": {f: np.asarray(getattr(result.dec, f), dtype=np.float64) for f in FIELDS},
            "hvgs": np.asarray(result.hvgs, dtype=np.int64),
            "fastmnn": harness.program_output(result.corrected)}


def _key(*arrays) -> str:
    digest = hashlib.sha256()
    for a in arrays:
        digest.update(np.ascontiguousarray(a, dtype=np.int64).tobytes() + b"|")
    return digest.hexdigest()


def _dec_err(got: dict, want: dict) -> float:
    errs = []
    for f in FIELDS:
        rms = math.sqrt(float(np.mean(want[f] ** 2)))
        errs.append(float(np.max(np.abs(got[f] - want[f]))) / rms)
    return max(errs)


def _hvg_miss(a, b) -> float:
    a, b = set(np.asarray(a).tolist()), set(np.asarray(b).tolist())
    return 1.0 - len(a & b) / len(a | b) if a | b else 0.0


def _padded(rows: torch.Tensor, hvgs, genes: int) -> torch.Tensor:
    """HVG rows in the rows of all ``genes``, zero elsewhere."""
    out = torch.zeros((genes, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out[torch.as_tensor(np.asarray(hvgs), device=rows.device)] = rows
    return out


class _Reference:
    """The reference's PCA of each HVG set and its merges, each computed
    once."""

    def __init__(self, cell, counts, model, precision="fp64", bf16=False):
        self.cfg, self.counts, self.model = cell.config, counts, model
        self.ar = reference.Arith(precision)
        self.bf16 = bf16
        self.pcas, self.merges = {}, {}

    def pca(self, hvgs):
        key = _key(hvgs)
        if key not in self.pcas:
            batches = quick_reference.hvg_log_counts(self.counts, self.model.factors, hvgs,
                                                     self.ar.dtype, self.bf16)
            pcs, rotation, _ = reference.pca(self.ar, batches, int(self.cfg["d"]))
            del batches
            rot_all, centers = quick_reference.all_gene_rotation(
                self.ar, self.counts, self.model.factors, hvgs, pcs=pcs, bf16=self.bf16)
            self.pcas[key] = (pcs, rotation, rot_all, centers)
        return self.pcas[key]

    def merge(self, hvgs, follow=None):
        key = (_key(hvgs), None if follow is None else _key(*follow))
        if key not in self.merges:
            pcs = self.pca(hvgs)[0]
            self.merges[key] = reference.merge(self.ar, pcs, int(self.cfg["k"]),
                                               float(self.cfg["ndist"]), "exact", follow)
        return self.merges[key]

    def output(self, hvgs, follow=None) -> dict:
        _, _, rot_all, centers = self.pca(hvgs)
        corrected, pairs = self.merge(hvgs, follow)
        return {"corrected": corrected, "pairs": pairs, "rotation": rot_all, "centers": centers}


def _readings(out: dict, ref: _Reference) -> dict:
    genes = int(ref.cfg["genes"])
    hvgs, own_hvgs = out["hvgs"], ref.model.hvgs
    fm = out["fastmnn"]
    if tuple(fm["rotation"].shape) != (genes, int(ref.cfg["d"])):
        return {name: float("nan") for name in READINGS}     # not the configured PCA
    got_hvg = fm["rotation"][torch.as_tensor(hvgs, device=fm["rotation"].device)]
    followed = ref.output(hvgs, fm["pairs"])
    ref_hvg = ref.pca(hvgs)[1]
    hvg_n = int(ref.cfg["hvg_n"])
    values = {"dec_err": _dec_err(out["dec"], ref.model.dec), "hvg_miss": _hvg_miss(hvgs, own_hvgs),
              "hvg_count_err": abs(len(hvgs) - hvg_n) / hvg_n}
    values.update(compare.readings({**fm, "rotation": got_hvg},
                                   {**followed, "rotation": ref_hvg}))
    # the reference's own HVGs, PCA and merge; the rotations meet on the
    # genes both chose (centers are not read from this comparison)
    own = ref.output(own_hvgs)
    values.update(compare.own_readings(
        {**fm, "rotation": _padded(got_hvg, hvgs, genes)},
        {**own, "rotation": _padded(ref.pca(own_hvgs)[1], own_hvgs, genes), "centers": fm["centers"]}))
    dev = followed["rotation"].device
    want, _ = quick_reference.all_gene_rotation(
        ref.ar, ref.counts, ref.model.factors, hvgs,
        rotation=got_hvg.to(dev, torch.float64), bf16=ref.bf16)
    got = fm["rotation"].to(dev, torch.float64)
    values["rotation_err"] = float((got - want).abs().max() / torch.sqrt((want * want).mean()))
    return values


def judge(cell, outputs, inputs):
    """(correct, worst readings, checks, number of outputs that failed)."""
    cfg = cell.config
    with torch.no_grad():
        model = quick_reference.variance_model(inputs, float(cfg["min_mean"]), int(cfg["hvg_n"]))
        ref = _Reference(cell, inputs, model)
        worst, failed = {}, 0
        for out in outputs.values():
            values = _readings(out, ref)
            failed += not compare.judge(values, cell.limits)[0]
            for k, v in values.items():
                old = worst.get(k)
                if old is None or (not math.isnan(old) and not v <= old):
                    worst[k] = v                  # the larger, or NaN for good
    correct, checks = compare.judge(worst, cell.limits)
    return correct and failed == 0, worst, checks, failed


def control(cell, inputs) -> dict:
    """The control's output: the reference in the program's place, one
    precision below what the configuration states."""
    cfg = cell.config
    with torch.no_grad():
        model = quick_reference.variance_model(inputs, float(cfg["min_mean"]), int(cfg["hvg_n"]),
                                               dtype=torch.float32, bf16=True)
        low = _Reference(cell, inputs, model, "tf32", bf16=True)
        return {"dec": model.dec, "hvgs": model.hvgs, "fastmnn": low.output(model.hvgs)}


@contextlib.contextmanager
def planted(name: str):
    if name in faults.FAULTS:
        with faults.planted(name):
            yield
        return
    from batchelor_torch.correct import experiments
    from batchelor_torch.ops import normalization, stats

    if name == "unrescaled_size_factors":
        def unrescaled(averages, size_factors, min_mean=1.0):
            return list(size_factors)
        patch = mock.patch.object(normalization, "rescale_size_factors", unrescaled)
    elif name == "hvgs_by_total":
        rank = experiments.get_top_hvgs

        def by_total(dec, *args, **kwargs):
            return rank(stats.GeneVarResult(mean=dec.mean, total=dec.total, tech=dec.tech,
                                            bio=dec.total), *args, **kwargs)
        patch = mock.patch.object(experiments, "get_top_hvgs", by_total)
    elif name == "trend_without_curve":
        fit = stats.fit_trend_var

        def no_curve(means, variances, span=0.3, parametric=True):
            return fit(means, variances, span=span, parametric=False)
        patch = mock.patch.object(stats, "fit_trend_var", no_curve)
    elif name == "floored_trend":
        from batchelor_torch.correct import diagnostics

        smoother = diagnostics._local_linear

        def floored(x, y, span):
            fit = smoother(x, y, span)
            return lambda q: np.maximum(fit(q), 0.0)
        patch = mock.patch.object(diagnostics, "_local_linear", floored)
    else:
        raise ValueError(f"unknown fault {name!r}")
    with patch:
        yield
