"""The port's column statistics against the JAX package and numpy.

The same column (from a numpy seed) goes to both packages, the JAX one in
interpret mode; ``histogram_full``, ``quantiles``, ``topk_values`` and
``describe`` must return the same numpy results (uint64 counts, uint32
values; tolerance 0).  A domain wider than 4096 values is one pass of the
port's domain histogram: held against the JAX package's 4096-value windows
at width 13 on a small column (one interpret-mode call), and against
numpy at widths 13-20 and in ``describe``; the width cap against the JAX
package's message.
"""
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import stats as jstats
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import stats as tstats
from shared_simd_scan_tpu_torch.ops import scan as tscan

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


def test_domain_pass_matches_jax_at_width_13():
    # one pass of the domain histogram against the JAX package's two
    # 4096-value windows (interpret mode)
    values = np.random.default_rng(13).integers(0, 1 << 13, size=3001).astype(np.uint32)
    values[-1] = (1 << 13) - 1
    jdev, tdev = _column(13, values)
    counts = tscan._histogram_domain_tiles(tdev.tiles, 13, values.size)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy().astype(np.uint64),
                                  jstats.histogram_full(jdev, interpret=True))
    np.testing.assert_array_equal(tstats.histogram_full(tdev), counts.numpy().astype(np.uint64))


@pytest.mark.parametrize("width", [14, 16, 20])
def test_domain_pass_matches_numpy(width):
    # small ragged n (padding in the last block and tile), a value in the
    # last window, a block_offset that moves n's tail
    dom = 1 << width
    for n in (1, 777, 8192 + 45):
        values = np.random.default_rng(width + n).integers(0, dom, size=n).astype(np.uint32)
        values[-1] = dom - 1
        tdev = tlayout.pack_device(values, width, device="cpu")
        counts = tscan._histogram_domain_tiles(tdev.tiles, width, n)
        np.testing.assert_array_equal(counts.numpy(), np.bincount(values, minlength=dom))
        np.testing.assert_array_equal(tstats.histogram_full(tdev), counts.numpy())
    shifted = tscan._histogram_domain_tiles(tdev.tiles, width, n + 32 * 200, 200)
    np.testing.assert_array_equal(shifted.numpy(), np.bincount(values, minlength=dom))
    with pytest.raises(ValueError, match="widths 13..20"):
        tscan._histogram_domain_tiles(tdev.tiles, 12, n)


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
