"""The port's column statistics against the JAX package and numpy.

The same column (from a numpy seed) goes to both packages, the JAX one in
interpret mode; ``histogram_full``, ``quantiles``, ``topk_values`` and
``describe`` must return the same numpy results (uint64 counts, uint32
values; tolerance 0).  Wider domains (several 4096-value windows) and the
width cap are checked against numpy only: the JAX interpret-mode
histogram at k = 4096 costs minutes.
"""
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import stats as jstats
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import stats as tstats

torch.set_num_threads(1)


def _column(width, values):
    jdev = jlayout.pack_device(values, width)
    return jdev, tlayout.from_jax_numpy(width, values.size, np.asarray(jdev.tiles), "cpu")


@pytest.mark.parametrize("width", [5, 6])  # the chunked DAG (k = 32) and the span (k = 64)
def test_stats_match_jax(width):
    rng = np.random.default_rng(width)
    values = rng.integers(0, 1 << width, size=6000, dtype=np.uint64).astype(np.uint32)
    values[:700] = 3  # a clear mode, and ties below it
    jdev, tdev = _column(width, values)
    counts = tstats.histogram_full(tdev)
    jcounts = jstats.histogram_full(jdev, interpret=True)
    assert counts.dtype == jcounts.dtype == np.uint64
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(counts, np.bincount(values, minlength=1 << width))
    qs = [0.0, 0.25, 0.5, 0.9, 1.0]
    q = tstats.quantiles(tdev, qs)
    np.testing.assert_array_equal(q, jstats.quantiles(jdev, qs, interpret=True))
    assert q.dtype == np.uint32
    svals = np.sort(values)
    assert q.tolist() == [int(svals[max(1, int(np.ceil(x * values.size))) - 1]) for x in qs]
    top, top_counts = tstats.topk_values(tdev, 5)
    jtop, jtop_counts = jstats.topk_values(jdev, 5, interpret=True)
    np.testing.assert_array_equal(top, jtop)
    np.testing.assert_array_equal(top_counts, jtop_counts)
    assert top[0] == 3 and top.dtype == np.uint32 and top_counts.dtype == np.uint64
    assert tstats.describe(tdev) == jstats.describe(jdev, interpret=True)


def test_two_windows_at_width_13():
    values = np.random.default_rng(2).integers(0, 1 << 13, size=50_000).astype(np.uint32)
    tdev = tlayout.pack_device(values, 13, device="cpu")
    counts = tstats.histogram_full(tdev)
    np.testing.assert_array_equal(counts, np.bincount(values, minlength=1 << 13))
    d = tstats.describe(tdev)
    assert (d["n"], d["min"], d["max"], d["distinct"]) == (
        values.size, int(values.min()), int(values.max()), int(np.unique(values).size))
    assert d["median"] == int(np.sort(values)[(values.size + 1) // 2 - 1])


def test_refusals_match_jax():
    values = np.arange(100, dtype=np.uint32)
    jdev, tdev = _column(9, values)
    object.__setattr__(jdev, "width", 31)
    object.__setattr__(tdev, "width", 31)
    with pytest.raises(ValueError) as jerr:
        jstats.histogram_full(jdev, interpret=True)
    with pytest.raises(ValueError, match="width 31") as terr:
        tstats.histogram_full(tdev)
    assert str(terr.value) == str(jerr.value)
    object.__setattr__(tdev, "width", 9)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tstats.describe(tdev, mesh=object())
    with pytest.raises(ValueError, match="quantile out of range"):
        tstats.quantiles(tdev, [0.5, 1.5])
