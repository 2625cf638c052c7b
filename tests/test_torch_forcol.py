"""The port's FOR encoding against the JAX package and numpy.

The same values (from a numpy seed) go to both packages; the JAX column
crosses into the port with ``layout.from_jax_numpy``.  ``pack_for`` must
give the JAX tiles and base, ``normalize`` the same rewritten predicates
(no kernel runs), ``evaluate`` the same words and count as the JAX one in
interpret mode, ``masked_aggregate`` the exact Python-int sum, and
``describe`` / ``quantiles`` numpy's results at every width (the JAX
package's only at width 5: its interpret-mode histograms are slow).
Tolerance 0 throughout.
"""
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import bitvector as jbitvector
from shared_simd_scan_tpu import forcol as jforcol
from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import forcol as tforcol
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import query as tq

torch.set_num_threads(1)

N = 6000  # b1 = 8: one tile shape for every column here
BASE = 1_700_000_000


def _band(span, seed, base=BASE, n=N):
    rng = np.random.default_rng(seed)
    vals = base + rng.integers(0, span, n, dtype=np.uint64)
    vals[0], vals[1] = base, base + span - 1  # both ends of the band
    return vals


def _pair(vals):
    """(JAX ForColumn, the port's ForColumn over the same tiles)."""
    jfc = jforcol.pack_for(vals)
    tdev = tlayout.from_jax_numpy(jfc.width, jfc.n, np.asarray(jfc.dev.tiles), "cpu")
    return jfc, tforcol.ForColumn(base=jfc.base, dev=tdev)


def _form(expr, names):
    """A predicate tree as nested tuples, its columns by name."""
    kind = type(expr).__name__
    if kind == "Range":
        return (kind, names[id(expr.col)], expr.lo, expr.hi)
    if kind == "In":
        return (kind, names[id(expr.col)], tuple(expr.keys))
    if kind == "Not":
        return (kind, _form(expr.term, names))
    return (kind, tuple(_form(t, names) for t in expr.terms))


@pytest.mark.parametrize("case", ["band9", "band17", "u64_near_2^62", "int32_tensor",
                                  "int64_tensor", "explicit_width"])
def test_pack_for_matches_jax(case):
    vals = _band(300 if case != "band17" else 86_400, seed=1)
    if case == "u64_near_2^62":
        vals = _band(1000, seed=2, base=(1 << 62) + 5)
    jfc = jforcol.pack_for(vals, width=20 if case == "explicit_width" else None)
    arg = {"int32_tensor": lambda: torch.from_numpy(vals.astype(np.int32)),
           "int64_tensor": lambda: torch.from_numpy(vals.astype(np.int64))}.get(case, lambda: vals)()
    tfc = tforcol.pack_for(arg, width=20 if case == "explicit_width" else None, device="cpu")
    assert (tfc.base, tfc.width, tfc.n) == (jfc.base, jfc.width, jfc.n)
    np.testing.assert_array_equal(tfc.dev.to_numpy(), np.asarray(jfc.dev.tiles))
    out = tforcol.unpack_for(tfc)
    assert out.dtype == np.uint64
    np.testing.assert_array_equal(out, vals.astype(np.uint64))


@pytest.mark.parametrize("vals,width", [(np.arange(100, dtype=np.uint32), 5),
                                        (np.arange(100, dtype=np.uint32), 32),
                                        (np.array([0, 1 << 31], np.uint64), None),
                                        (np.zeros(0, np.uint32), None)])
def test_pack_for_refusals_match_jax(vals, width):
    with pytest.raises(ValueError) as jerr:
        jforcol.pack_for(vals, width=width)
    with pytest.raises(ValueError) as terr:
        tforcol.pack_for(vals, width=width, device="cpu")
    assert str(terr.value) == str(jerr.value)


def _sweep(q, fc, plain, w):
    """In-band, edge and out-of-band predicates on a FOR column of width w."""
    top = BASE + (1 << w)
    leaves = [
        q.Eq(fc, BASE + 17), q.Eq(fc, BASE), q.Eq(fc, BASE - 1), q.Eq(fc, top - 1),
        q.Eq(fc, top), q.Range(fc, BASE + 10, BASE + 50), q.Range(fc, 0, BASE + 3),
        q.Range(fc, BASE + 5, 1 << 40), q.Range(fc, 0, BASE), q.Range(fc, top, top + 9),
        q.Range(fc, BASE + 9, BASE + 9), q.Range(fc, BASE + 9, BASE + 2),
        q.Range(fc, 0, 1 << 62), q.Range(fc, top - 1, top),
        q.In(fc, [BASE + 3, BASE - 1, top, top - 1, BASE + 3, 7]), q.In(fc, []),
        q.In(fc, [1 << 40]), q.Range(plain, 3, 90), q.In(plain, [1, 2]),
    ]
    trees = [q.Not(leaves[5]), q.And(leaves[0], leaves[17], q.Not(leaves[14])),
             q.Or(leaves[9], leaves[15], q.And(leaves[6], leaves[18]))]
    return leaves + trees


@pytest.mark.parametrize("span", [300, 1 << 31])
def test_normalize_matches_jax(span):
    jfc, tfc = _pair(_band(span, seed=3))
    pv = np.random.default_rng(4).integers(0, 512, N, dtype=np.uint64).astype(np.uint32)
    jplain = jlayout.pack_device(pv, 9)
    tplain = tlayout.from_jax_numpy(9, N, np.asarray(jplain.tiles), "cpu")
    jnames = {id(jfc.dev): "for", id(jplain): "plain"}
    tnames = {id(tfc.dev): "for", id(tplain): "plain"}
    jexprs = _sweep(jq, jfc, jplain, jfc.width)
    texprs = _sweep(tq, tfc, tplain, tfc.width)
    for jexpr, texpr in zip(jexprs, texprs):
        assert _form(tforcol.normalize(texpr), tnames) == _form(jforcol.normalize(jexpr), jnames)
    if span == 1 << 31:  # width 31: hi clamps to 2^31, past int32
        assert tfc.width == 31
        assert tforcol.normalize(tq.Range(tfc, BASE + 5, 1 << 40)).hi == 1 << 31


def _trees(q, fc, plain):
    return {
        # Eq, Range and an In with an out-of-band key, merged by the planner
        "or": q.Or(q.Eq(fc, BASE + 123), q.Range(fc, BASE + 10, BASE + 50),
                   q.In(fc, [BASE + 200, BASE + 201, BASE - 1000])),
        # a FOR range fused with a plain column's, under a complement
        "and_plain": q.Not(q.And(q.Range(fc, BASE + 100, BASE + 200), q.Range(plain, 0, 256))),
        # out-of-band predicates are constants; the full band matches everything
        "constants": q.Or(q.Range(fc, BASE + 500_000, BASE + 900_000),
                          q.Not(q.Range(fc, 0, 1 << 40))),
    }


def _truth(name, v, pv):
    if name == "or":
        return (v == BASE + 123) | ((v >= BASE + 10) & (v < BASE + 50)) \
            | np.isin(v, [BASE + 200, BASE + 201])
    if name == "and_plain":
        return ~((v >= BASE + 100) & (v < BASE + 200) & (pv < 256))
    return np.zeros(v.size, bool)


@pytest.mark.parametrize("name", ["or", "and_plain", "constants"])
def test_evaluate_matches_jax(name):
    vals = _band(300, seed=5)
    jfc, tfc = _pair(vals)
    pv = np.random.default_rng(6).integers(0, 512, N, dtype=np.uint64).astype(np.uint32)
    jplain = jlayout.pack_device(pv, 9)
    tplain = tlayout.from_jax_numpy(9, N, np.asarray(jplain.tiles), "cpu")
    jbits, jcount = jforcol.evaluate(_trees(jq, jfc, jplain)[name], interpret=True)
    tbits, tcount = tforcol.evaluate(_trees(tq, tfc, tplain)[name])
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    expect = _truth(name, vals, pv)
    assert int(tcount) == int(jcount) == int(expect.sum())
    np.testing.assert_array_equal(tbitvector.to_bool(tbits, N).numpy(), expect)


def test_evaluate_width31_hi_2_31_matches_jax():
    # the offsets need all 31 bits; Range's hi clamps to 2^31 = the domain
    vals = _band(1 << 31, seed=7)
    jfc, tfc = _pair(vals)
    assert jfc.width == tfc.width == 31
    lo = BASE + (1 << 30)
    jbits, jcount = jforcol.evaluate(jq.Range(jfc, lo, 1 << 40), interpret=True)
    tbits, tcount = tforcol.evaluate(tq.Range(tfc, lo, 1 << 40))
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    assert int(tcount) == int(jcount) == int((vals >= lo).sum())


@pytest.mark.parametrize("base", [(1 << 32) - 1000, (1 << 62) + 3])
def test_masked_aggregate_is_exact(base):
    vals = _band(1000, seed=8, base=base)
    mask = np.random.default_rng(9).random(N) < 0.6
    tfc = tforcol.pack_for(vals, device="cpu")
    s, c = tforcol.masked_aggregate(tfc, tbitvector.from_bool(torch.from_numpy(mask)))
    want = sum(int(x) for x in vals[mask])
    assert int(c) == int(mask.sum())
    assert s == want
    if base > 1 << 32:
        assert want > 1 << 63  # past int64: summed in Python ints
        jfc = jforcol.pack_for(vals)
        js, jc = jforcol.masked_aggregate(jfc, jbitvector.from_bool(mask), interpret=True)
        assert (js, int(jc)) == (s, int(c))


def _numpy_describe(vals, base):
    v = np.sort(vals.astype(np.uint64))
    n = v.size
    return {"n": n, "min": int(v[0]), "max": int(v[-1]),
            "mean": int((v - np.uint64(base)).sum()) / n + base,
            "median": int(v[(n + 1) // 2 - 1]), "distinct": int(np.unique(v).size)}


QS = [0.0, 0.01, 0.25, 0.5, 0.9, 1.0]


@pytest.mark.parametrize("span", [300, 5000, 86_400])  # widths 9, 13, 17
def test_describe_and_quantiles_match_numpy(span):
    vals = _band(span, seed=10)
    tfc = tforcol.pack_for(vals, device="cpu")
    assert tforcol.describe(tfc) == _numpy_describe(vals, tfc.base)
    got = tforcol.quantiles(tfc, QS)
    v = np.sort(vals)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, [v[max(1, int(np.ceil(q * N))) - 1] for q in QS])


def test_describe_and_quantiles_match_jax_at_width_5():
    vals = _band(20, seed=11)
    jfc, tfc = _pair(vals)
    assert tfc.width == 5
    assert tforcol.describe(tfc) == jforcol.describe(jfc, interpret=True) \
        == _numpy_describe(vals, tfc.base)
    jq_ = jforcol.quantiles(jfc, QS, interpret=True)
    tq_ = tforcol.quantiles(tfc, QS)
    assert tq_.dtype == jq_.dtype == np.uint64
    np.testing.assert_array_equal(tq_, jq_)
