"""The port's NULL-aware evaluation against the JAX package and numpy.

The same values and NULL masks (from a numpy seed) go to both packages;
the port's column crosses from the JAX one with ``layout.from_jax_numpy``
and its NULL words are the JAX words, bit for bit.  ``evaluate`` must give
the JAX words and count (``interpret=True``) on five trees, and a numpy
three-valued (Kleene) truth over a seeded fuzz of nested trees; an And or
Or hands its pure (non-nullable) siblings to the planner as one subtree.
Tolerance 0 throughout.
"""
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import nullable as jnullable
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import nullable as tnullable
from shared_simd_scan_tpu_torch import query as tq

torch.set_num_threads(1)

N = 6000  # b1 = 8: one tile shape for every column here
T, U, F = 1, 0, -1  # Kleene truth values of the numpy oracle


def _cross(jdev):
    return tlayout.from_jax_numpy(jdev.width, jdev.n, np.asarray(jdev.tiles), "cpu")


def _nullable_pair(width, null_frac, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, N, dtype=np.uint64).astype(np.uint32)
    nulls = rng.random(N) < null_frac
    jnc = jnullable.pack_nullable(vals, nulls, width)
    tnc = tnullable.NullableColumn(
        dev=_cross(jnc.dev), nulls=torch.from_numpy(np.array(jnc.nulls).view(np.int32)))
    return vals, nulls, jnc, tnc


def _plain_pair(width, seed):
    vals = np.random.default_rng(seed).integers(0, 1 << width, N, dtype=np.uint64)
    jdev = jlayout.pack_device(vals.astype(np.uint32), width)
    return vals.astype(np.uint32), jdev, _cross(jdev)


@pytest.fixture(scope="module")
def table():
    a = _nullable_pair(9, 0.2, seed=1)
    b = _nullable_pair(7, 0.1, seed=2)
    p = _plain_pair(9, seed=3)
    s = _plain_pair(4, seed=4)
    return a, b, p, s


def test_pack_nullable_matches_jax(table):
    (av, an, jnc, tnc), _, _, _ = table
    for arg_v, arg_n in ((av, an), (torch.from_numpy(av.view(np.int32)), torch.from_numpy(an))):
        got = tnullable.pack_nullable(arg_v, arg_n, 9, device="cpu")
        np.testing.assert_array_equal(got.dev.to_numpy(), np.asarray(jnc.dev.tiles))
        np.testing.assert_array_equal(got.nulls.numpy().view(np.uint32), np.asarray(jnc.nulls))
        assert got.nulls.dtype == torch.int32 and (got.n, got.width) == (N, 9)


def test_pack_nullable_refuses_a_shape_mismatch():
    with pytest.raises(ValueError) as jerr:
        jnullable.pack_nullable(np.zeros(10, np.uint32), np.zeros(5, bool), 9)
    with pytest.raises(ValueError) as terr:
        tnullable.pack_nullable(np.zeros(10, np.uint32), np.zeros(5, bool), 9, device="cpu")
    assert str(terr.value) == str(jerr.value)


def _trees(q, a, b, p, s):
    return {
        "leaf": q.Eq(a, 0),  # the stored 0 at NULL slots must not match
        "not": q.Not(q.Eq(a, 7)),
        "or_null_true": q.Or(q.Eq(a, 5), q.Range(b, 0, 64)),
        "nested": q.And(q.Not(q.Or(q.Eq(a, 3), q.Range(b, 10, 50))), q.Range(a, 0, 400)),
        "mixed_pure": q.Or(q.And(q.Range(p, 100, 300), q.Range(s, 2, 9), q.Not(q.In(a, [2, 9]))),
                           q.In(s, [1, 4])),
    }


def _leaf(match, null):
    out = np.where(match, T, F)
    out[null] = U
    return out


def _truth(name, a, b, p, s):
    av, an = a
    bv, bn = b
    none = np.zeros(N, bool)
    if name == "leaf":
        return _leaf(av == 0, an)
    if name == "not":
        return -_leaf(av == 7, an)
    if name == "or_null_true":
        return np.maximum(_leaf(av == 5, an), _leaf(bv < 64, bn))
    if name == "nested":
        inner = np.maximum(_leaf(av == 3, an), _leaf((bv >= 10) & (bv < 50), bn))
        return np.minimum(-inner, _leaf(av < 400, an))
    pure = _leaf((p >= 100) & (p < 300) & (s >= 2) & (s < 9), none)
    conj = np.minimum(pure, -_leaf(np.isin(av, [2, 9]), an))
    return np.maximum(conj, _leaf(np.isin(s, [1, 4]), none))


@pytest.mark.parametrize("name", ["leaf", "not", "or_null_true", "nested", "mixed_pure"])
def test_kleene_matches_jax(table, name):
    (av, an, ja, ta), (bv, bn, jb, tb), (pv, jp, tp), (sv, js, ts) = table
    jbits, jcount = jnullable.evaluate(_trees(jq, ja, jb, jp, js)[name], interpret=True)
    tbits, tcount = tnullable.evaluate(_trees(tq, ta, tb, tp, ts)[name])
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    expect = _truth(name, (av, an), (bv, bn), pv, sv) == T
    assert tcount.dtype == torch.int64
    assert int(tcount) == int(jcount) == int(expect.sum())
    np.testing.assert_array_equal(tbitvector.to_bool(tbits, N).numpy(), expect)


def _random_tree(rng, cols, depth):
    """-> (port tree, numpy three-valued truth)."""
    if depth == 0 or rng.random() < 0.3:
        name = rng.choice(list(cols))
        col, vals, nulls, width = cols[name]
        if rng.random() < 0.5:
            lo = int(rng.integers(0, 1 << width))
            hi = lo + int(rng.integers(1, 1 << width))
            return tq.Range(col, lo, hi), _leaf((vals >= lo) & (vals < hi), nulls)
        keys = rng.integers(0, 1 << width, int(rng.integers(0, 5))).tolist()
        return tq.In(col, keys), _leaf(np.isin(vals, keys), nulls)
    op = rng.choice(["and", "or", "not"])
    if op == "not":
        t, v = _random_tree(rng, cols, depth - 1)
        return tq.Not(t), -v
    kids = [_random_tree(rng, cols, depth - 1) for _ in range(int(rng.integers(2, 4)))]
    ctor, red = (tq.And, np.minimum) if op == "and" else (tq.Or, np.maximum)
    return ctor(*[t for t, _ in kids]), red.reduce([v for _, v in kids])


def test_kleene_fuzz_matches_numpy(table):
    (av, an, _, ta), (bv, bn, _, tb), (pv, _, tp), (sv, _, ts) = table
    none = np.zeros(N, bool)
    cols = {"a": (ta, av, an, 9), "b": (tb, bv, bn, 7), "p": (tp, pv, none, 9),
            "s": (ts, sv, none, 4)}
    rng = np.random.default_rng(11)
    for _ in range(40):
        tree, truth = _random_tree(rng, cols, depth=3)
        if not tnullable._has_nullable(tree):
            tree = tq.And(tree, tq.Not(tq.In(ta, [])))  # TRUE where a is not NULL
            truth = np.minimum(truth, _leaf(np.ones(N, bool), an))
        bits, count = tnullable.evaluate(tree)
        expect = truth == T
        assert int(count) == int(expect.sum())
        np.testing.assert_array_equal(tbitvector.to_bool(bits, N).numpy(), expect)


@pytest.mark.parametrize("op", ["And", "Or"])
def test_pure_siblings_reach_the_planner_as_one_subtree(table, monkeypatch, op):
    (av, an, _, ta), _, (pv, _, tp), (sv, _, ts) = table
    calls = []
    real = tnullable.q.evaluate

    def spy(expr):
        calls.append(expr)
        return real(expr)

    monkeypatch.setattr(tnullable.q, "evaluate", spy)
    ctor = getattr(tq, op)
    bits, count = tnullable.evaluate(
        ctor(tq.Range(tp, 100, 300), tq.Range(ts, 2, 9), tq.Not(tq.Eq(ta, 2))))
    known = (av != 2) & ~an
    if op == "And":
        expect = (pv >= 100) & (pv < 300) & (sv >= 2) & (sv < 9) & known
    else:
        expect = ((pv >= 100) & (pv < 300)) | ((sv >= 2) & (sv < 9)) | known
    assert int(count) == int(expect.sum())
    # one planner call for both pure ranges, one for the nullable leaf
    grouped = [e for e in calls if isinstance(e, ctor)]
    assert len(calls) == 2 and len(grouped) == 1 and len(grouped[0].terms) == 2
