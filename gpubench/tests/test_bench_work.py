"""The roofline work count against a count by hand."""
import pytest

from gpubench import work


def test_three_batches_by_hand():
    sizes, d, k = [1000, 2000, 500], 50, 20
    assert list(work.searches(sizes)) == [(1000, 2000), (2000, 1000), (3000, 500), (500, 3000)]
    peaks = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    # step 1: 2 searches of 1000 x 2000 scores; step 2: 2 of 3000 x 500
    flops = [2 * 50 * 2e6, 2 * 50 * 2e6, 2 * 50 * 1.5e6, 2 * 50 * 1.5e6]
    nbytes = [3000 * 200 + 1000 * 240, 3000 * 200 + 2000 * 240,
              3500 * 200 + 3000 * 240, 3500 * 200 + 500 * 240]
    want = sum(max(f / 1e12, b / 1e9) for f, b in zip(flops, nbytes))
    assert work.mnn_search_least_seconds(sizes, d, k, peaks) == pytest.approx(want, rel=1e-12)


def test_the_card_peaks():
    assert work.peaks()["bf16_flops_per_s"] == 989e12
    assert work.peaks()["hbm_bytes_per_s"] == 3.35e12
    # the atlas: 7 steps, 2 x 47,250^2 x m scores each, bound by the flops
    t = work.mnn_search_least_seconds([47250] * 8, 50, 20)
    assert t == pytest.approx(100 * 2 * 47250 ** 2 * 28 / 989e12, rel=1e-3)
