"""The port's dictionary encoding against the JAX package and numpy.

The same sparse 40-bit values (from a numpy seed) go to both packages; the
JAX code column crosses into the port with ``layout.from_jax_numpy``.
``pack_dict`` must give the JAX dictionary and tiles, ``normalize`` the
same rewritten predicates (no kernel runs), ``evaluate`` the same words and
count as the JAX one in interpret mode (also on a tree that mixes a
dictionary and a FOR column), and ``topk_values`` / ``describe`` numpy's
results, and the JAX package's at width 2.  Tolerance 0 throughout.
"""
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import dictcol as jdictcol
from shared_simd_scan_tpu import forcol as jforcol
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import dictcol as tdictcol
from shared_simd_scan_tpu_torch import forcol as tforcol
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import query as tq

torch.set_num_threads(1)

N = 6000  # b1 = 8: one tile shape for every column here


def _sparse(n=N, seed=0, distinct=200):
    # distinct values scattered over a 40-bit domain
    rng = np.random.default_rng(seed)
    domain = np.sort(rng.choice(np.uint64(1) << np.uint64(40), size=distinct, replace=False))
    return domain[rng.integers(0, domain.size, n)], domain


def _cross(jdev):
    return tlayout.from_jax_numpy(jdev.width, jdev.n, np.asarray(jdev.tiles), "cpu")


def _pair(vals):
    """(JAX DictColumn, the port's DictColumn over the same dictionary and tiles)."""
    jdc = jdictcol.pack_dict(vals)
    return jdc, tdictcol.DictColumn(values=np.asarray(jdc.values), dev=_cross(jdc.dev))


def _form(expr, names):
    kind = type(expr).__name__
    if kind == "Range":
        return (kind, names[id(expr.col)], expr.lo, expr.hi)
    if kind == "In":
        return (kind, names[id(expr.col)], tuple(expr.keys))
    if kind == "Not":
        return (kind, _form(expr.term, names))
    return (kind, tuple(_form(t, names) for t in expr.terms))


@pytest.mark.parametrize("case", ["sparse", "tensor", "explicit_width", "one_value"])
def test_pack_dict_matches_jax(case):
    vals, _ = _sparse(seed=1)
    if case == "one_value":
        vals = np.full(N, 1 << 63, np.uint64)
    width = 12 if case == "explicit_width" else None
    jdc = jdictcol.pack_dict(vals, width=width)
    arg = torch.from_numpy(vals.astype(np.int64)) if case == "tensor" else vals
    tdc = tdictcol.pack_dict(arg, width=width, device="cpu")
    assert (tdc.width, tdc.n) == (jdc.width, jdc.n)
    assert tdc.values.dtype == np.uint64
    np.testing.assert_array_equal(tdc.values, jdc.values)
    np.testing.assert_array_equal(tdc.dev.to_numpy(), np.asarray(jdc.dev.tiles))
    np.testing.assert_array_equal(tdictcol.unpack_dict(tdc), vals)


@pytest.mark.parametrize("vals,width", [(np.arange(100, dtype=np.uint64), 5),
                                        (np.arange(100, dtype=np.uint64), 32),
                                        (np.zeros(0, np.uint64), None)])
def test_pack_dict_refusals_match_jax(vals, width):
    with pytest.raises(ValueError) as jerr:
        jdictcol.pack_dict(vals, width=width)
    with pytest.raises(ValueError) as terr:
        tdictcol.pack_dict(vals, width=width, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_normalize_matches_jax():
    vals, domain = _sparse(seed=2)
    jdc, tdc = _pair(vals)
    band = np.random.default_rng(3).integers(9_000, 9_500, N, dtype=np.uint64)
    jfc = jforcol.pack_for(band)
    tfc = tforcol.ForColumn(base=jfc.base, dev=_cross(jfc.dev))
    d = [int(x) for x in domain]
    top = (1 << 63) - 1  # past the 40-bit dictionary (numpy reads key lists as int64)

    def sweep(q, dc, fc):
        leaves = [q.Eq(dc, d[5]), q.Eq(dc, d[0] + 1), q.Eq(dc, d[0]), q.Eq(dc, d[-1]),
                  q.Eq(dc, top - 1), q.Range(dc, d[40], d[120]), q.Range(dc, d[40] + 1, d[120] + 1),
                  q.Range(dc, 0, d[0]), q.Range(dc, 0, top), q.Range(dc, d[-1] + 1, top),
                  q.Range(dc, d[9], d[9]), q.Range(dc, d[9], d[3]),
                  q.In(dc, [d[7], d[7], d[0] + 1, d[-1], top]), q.In(dc, []),
                  q.In(dc, [d[3] + 1]), q.Range(fc, 9_100, 9_300)]
        trees = [q.Not(leaves[5]), q.And(leaves[0], leaves[15], q.Not(leaves[12])),
                 q.Or(leaves[9], leaves[13], q.And(leaves[6], leaves[15]))]
        return leaves + trees

    jnames = {id(jdc.dev): "dict", id(jfc): "for"}
    tnames = {id(tdc.dev): "dict", id(tfc): "for"}
    for jexpr, texpr in zip(sweep(jq, jdc, jfc), sweep(tq, tdc, tfc)):
        assert _form(tdictcol.normalize(texpr), tnames) == _form(jdictcol.normalize(jexpr), jnames)


@pytest.mark.parametrize("name", ["or", "mixed_for"])
def test_evaluate_matches_jax(name):
    vals, domain = _sparse(seed=4)
    jdc, tdc = _pair(vals)
    band = np.random.default_rng(5).integers(9_000, 9_500, N, dtype=np.uint64)
    jfc = jforcol.pack_for(band)
    tfc = tforcol.ForColumn(base=jfc.base, dev=_cross(jfc.dev))
    d = [int(x) for x in domain]
    absent = d[0] + 1  # between dictionary entries

    def tree(q, dc, fc):
        if name == "or":
            return q.Or(q.Range(dc, d[40], d[120]), q.Eq(dc, d[150]), q.In(dc, [d[5], absent]))
        return q.And(q.Range(dc, d[20], d[180]), q.Range(fc, 9_100, 9_300))

    jbits, jcount = jdictcol.evaluate(tree(jq, jdc, jfc), interpret=True)
    tbits, tcount = tdictcol.evaluate(tree(tq, tdc, tfc))
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    if name == "or":
        expect = ((vals >= d[40]) & (vals < d[120])) | (vals == d[150]) | (vals == d[5])
    else:
        expect = (vals >= d[20]) & (vals < d[180]) & (band >= 9_100) & (band < 9_300)
    assert int(tcount) == int(jcount) == int(expect.sum())
    np.testing.assert_array_equal(tbitvector.to_bool(tbits, N).numpy(), expect)


def _numpy_describe(vals):
    v = np.sort(vals)
    n = v.size
    return {"n": n, "min": int(v[0]), "max": int(v[-1]), "mean": sum(int(x) for x in v) / n,
            "median": int(v[(n + 1) // 2 - 1]), "distinct": int(np.unique(v).size)}


def _numpy_topk(vals, k):
    uniq, counts = np.unique(vals, return_counts=True)
    order = np.lexsort((np.arange(uniq.size), -counts.astype(np.int64)))[:k]
    return uniq[order], counts[order].astype(np.uint64)


@pytest.mark.parametrize("distinct,k", [(200, 5), (3, 10), (1000, 1)])  # widths 8, 2, 10
def test_topk_and_describe_match_numpy(distinct, k):
    vals, _ = _sparse(seed=6, distinct=distinct)
    tdc = tdictcol.pack_dict(vals, device="cpu")
    top, counts = tdictcol.topk_values(tdc, k)
    want_top, want_counts = _numpy_topk(vals, k)
    assert top.dtype == np.uint64 and top.shape[0] == min(k, distinct)
    np.testing.assert_array_equal(top, want_top)
    np.testing.assert_array_equal(counts, want_counts)
    assert tdictcol.describe(tdc) == _numpy_describe(vals)


def test_topk_capped_and_64bit_mean_match_jax():
    # 3 distinct values at width 2: the cap is the dictionary's size (3),
    # not the histogram's domain (4); the mean of values near 2^62 is exact
    big = 1 << 62
    vals = np.array([big, big, big + 6, 10] * 5, np.uint64)
    jdc, tdc = _pair(vals)
    assert tdc.width == 2
    top, counts = tdictcol.topk_values(tdc, 10)
    jtop, jcounts = jdictcol.topk_values(jdc, 10, interpret=True)
    assert top.shape[0] == 3
    np.testing.assert_array_equal(top, jtop)
    np.testing.assert_array_equal(counts, jcounts)
    d = tdictcol.describe(tdc)
    assert d == jdictcol.describe(jdc, interpret=True) == _numpy_describe(vals)
    assert d["mean"] == (big * 15 + 6 * 5 + 10 * 5) / 20
