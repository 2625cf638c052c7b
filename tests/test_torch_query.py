"""The port's predicate-tree query layer against the JAX package and numpy.

The same table (three columns of the analytics demo's widths, from a numpy
seed) goes to both packages, the JAX one in interpret mode; the columns
cross with ``layout.from_jax_numpy``.  ``evaluate`` must give the same
words and count in both and equal the numpy predicate (tolerance 0);
``explain`` must give the same text.
"""
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import query as tq
from shared_simd_scan_tpu_torch import zonemap as tzonemap
from shared_simd_scan_tpu_torch.ops import member as tmember
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 5000  # ragged: the last block holds 8 values
WIDTHS = {"price": 9, "region": 5, "status": 4}


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(7)
    values, jcols, tcols = {}, {}, {}
    for name, width in WIDTHS.items():
        values[name] = rng.integers(0, 1 << width, N, dtype=np.uint64).astype(np.uint32)
        jcols[name] = jlayout.pack_device(values[name], width)
        tcols[name] = tlayout.from_jax_numpy(width, N, np.asarray(jcols[name].tiles), "cpu")
    return values, jcols, tcols


def _both(build, table):
    """The same tree over the JAX columns and over the port's."""
    _, jcols, tcols = table
    return build(jq, jcols), build(tq, tcols)


def _check(build, table, expect=None):
    jexpr, texpr = _both(build, table)
    jbits, jcount = jq.evaluate(jexpr, interpret=True)
    tbits, tcount = tq.evaluate(texpr)
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    assert int(tcount) == int(jcount)
    if expect is not None:
        np.testing.assert_array_equal(tbitvector.to_bool(tbits, N).numpy(), expect)
        assert int(tcount) == int(expect.sum())
    assert tq.explain(texpr) == jq.explain(jexpr)
    return tbits


def _demo(q, c):
    return q.And(q.Range(c["price"], 100, 400), q.Range(c["region"], 2, 10),
                 q.Or(q.In(c["status"], [1, 4, 9]), q.Eq(c["status"], 0)))


def test_demo_where_clause(table):
    v = table[0]
    expect = ((v["price"] >= 100) & (v["price"] < 400) & (v["region"] >= 2) & (v["region"] < 10)
              & (np.isin(v["status"], [1, 4, 9]) | (v["status"] == 0)))
    _check(_demo, table, expect)
    assert "member:window-popmask(1 windows)" in tq.explain(_both(_demo, table)[1])


def test_or_of_ranges_and_eq(table):
    v = table[0]

    def build(q, c):
        return q.Or(q.Range(c["price"], 0, 50), q.Range(c["price"], 300, 350),
                    q.Range(c["price"], 500, 512), q.Eq(c["region"], 7), q.Range(c["status"], 9, 3))

    expect = ((v["price"] < 50) | ((v["price"] >= 300) & (v["price"] < 350))
              | (v["price"] >= 500) | (v["region"] == 7))
    _check(build, table, expect)


def test_not_of_a_three_column_conjunction(table):
    v = table[0]

    def build(q, c):
        return q.Not(q.And(q.Eq(c["price"], 3), q.Eq(c["region"], 4), q.Eq(c["status"], 5)))

    expect = ~((v["price"] == 3) & (v["region"] == 4) & (v["status"] == 5))
    bits = _check(build, table, expect)
    # the complement keeps the tail past n zero
    assert int(tbitvector.popcount(bits)) == int(expect.sum())


def test_or_past_32_ranges(table):
    v = table[0]
    spans = [(7 * i, 7 * i + 3) for i in range(40)]

    def build(q, c):
        return q.Or(*[q.Range(c["price"], lo, hi) for lo, hi in spans])

    expect = np.zeros(N, bool)
    for lo, hi in spans:
        expect |= (v["price"] >= lo) & (v["price"] < hi)
    _check(build, table, expect)


def test_more_than_max_columns_ranges():
    rng = np.random.default_rng(3)
    widths = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12]
    values = [rng.integers(0, 1 << w, N, dtype=np.uint64).astype(np.uint32) for w in widths]
    jcols = [jlayout.pack_device(v, w) for v, w in zip(values, widths)]
    tcols = [tlayout.from_jax_numpy(w, N, np.asarray(j.tiles), "cpu") for j, w in zip(jcols, widths)]
    bounds = [(0, (1 << w) - 1) for w in widths]
    jexpr = jq.And(*[jq.Range(c, lo, hi) for c, (lo, hi) in zip(jcols, bounds)])
    texpr = tq.And(*[tq.Range(c, lo, hi) for c, (lo, hi) in zip(tcols, bounds)])
    jbits, jcount = jq.evaluate(jexpr, interpret=True)
    tbits, tcount = tq.evaluate(texpr)
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    expect = np.ones(N, bool)
    for v, (lo, hi) in zip(values, bounds):
        expect &= (v >= lo) & (v < hi)
    assert int(tcount) == int(jcount) == int(expect.sum())
    assert tq.explain(texpr) == jq.explain(jexpr)
    assert tq.explain(texpr).count("conj:fused-range") == 2  # groups of 8 and 2


def test_empty_in_and_or(table):
    v = table[0]

    def build(q, c):
        return q.Or(q.In(c["price"], []), q.And(), q.Or(), q.Not(q.In(c["region"], [])))

    _check(build, table, np.ones(N, bool))
    _check(lambda q, c: q.Or(q.Or(), q.In(c["status"], [])), table, np.zeros(N, bool))
    _check(lambda q, c: q.And(q.In(c["status"], [2, 3]), q.Range(c["price"], 1, 500)), table,
           np.isin(v["status"], [2, 3]) & (v["price"] >= 1) & (v["price"] < 500))


def test_statically_empty_intersection(table):
    def build(q, c):
        return q.And(q.Range(c["price"], 10, 200), q.Range(c["price"], 300, 400),
                     q.Eq(c["region"], 3))

    _check(build, table, np.zeros(N, bool))
    assert tq.explain(_both(build, table)[1]) \
        == "constant: statically empty range intersection -> zeros"


def test_explain_names_every_member_tier(table):
    _, jcols, tcols = table
    sets = [([5, 6, 7, 8], "interval"), ([0, 2, 4, 6], "window"),
            ([3, 70, 141, 200, 262, 333, 400, 511], "or-tree"), ([7, 450], "compare")]
    for keys, tier in sets:
        text = tq.explain(tq.In(tcols["price"], keys))
        assert text == jq.explain(jq.In(jcols["price"], keys)) and tier in text
    text = tq.explain(tq.In(tcols["status"], [1, 4, 9, 0, 40]))
    assert text == jq.explain(jq.In(jcols["status"], [1, 4, 9, 0, 40]))
    assert "domain-bitmap(1 words)" in text


def test_refusals(table):
    _, _, tcols = table
    other = tlayout.pack_device(np.zeros(100, np.uint32), 9, device="cpu")
    with pytest.raises(ValueError, match="share n"):
        tq.evaluate(tq.And(tq.Eq(tcols["price"], 1), tq.Eq(other, 1)))
    # zone maps prune the scan; the result is the one without them
    price = tcols["price"]
    zmaps = {id(price): tzonemap.build_zonemap(price, zone_b1=8)}
    for expr in (tq.Eq(price, 1), tq.And(tq.Range(price, 3, 90), tq.Eq(tcols["region"], 4))):
        bits, count = tq.evaluate(expr, zonemaps=zmaps)
        plain_bits, plain_count = tq.evaluate(expr)
        assert torch.equal(bits, plain_bits) and int(count) == int(plain_count)
    with pytest.raises(TypeError):
        tq.evaluate("price < 3")
    # In copies nothing to the host behind the caller's back; a CPU tensor is fine
    assert tq.In(tcols["price"], torch.tensor([1, 2])).keys == (1, 2)


def test_query_launches_nothing_on_the_cpu(table):
    fns = [tmember._member_window_tiles, tmember._member_ortree_tiles]
    before = [profiling.launch_count(f) for f in fns]
    _check(_demo, table)
    assert [profiling.launch_count(f) for f in fns] == before


SORTED_N = 16 * 4096  # 16 block rows: two zones of 8, so a range in one prunes in place
WIDE_WIDTHS = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12]  # ten columns: two conjunction groups


@pytest.fixture(scope="module")
def routed_table(table):
    """The table's columns, ten more for a two-group conjunction (w0-w9) and
    a sorted 9-bit column of SORTED_N values for the zone map."""
    values, jcols, tcols = (dict(d) for d in table)
    rng = np.random.default_rng(11)
    cols = [(f"w{i}", w, N) for i, w in enumerate(WIDE_WIDTHS)] + [("sorted", 9, SORTED_N)]
    for name, width, n in cols:
        values[name] = rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
        if name == "sorted":
            values[name] = np.sort(values[name])
        jcols[name] = jlayout.pack_device(values[name], width)
        tcols[name] = tlayout.from_jax_numpy(width, n, np.asarray(jcols[name].tiles), "cpu")
    return values, jcols, tcols


def _between(x, lo, hi):
    return (x >= lo) & (x < hi)


# (tree, its numpy predicate, where the count comes from: the kernel that
# wrote the words, or the popcount after a combine)
ROUTES = {
    "range": (lambda q, c: q.Range(c["price"], 100, 400),
              lambda v: _between(v["price"], 100, 400), "kernel"),
    "eq": (lambda q, c: q.Eq(c["region"], 7), lambda v: v["region"] == 7, "kernel"),
    "flight1_and": (
        lambda q, c: q.And(q.Range(c["price"], 50, 300), q.Range(c["region"], 1, 25),
                           q.Eq(c["status"], 3)),
        lambda v: _between(v["price"], 50, 300) & _between(v["region"], 1, 25)
        & (v["status"] == 3), "kernel"),
    "and_one_column": (
        lambda q, c: q.And(q.Range(c["price"], 50, 300), q.Range(c["price"], 200, 400)),
        lambda v: _between(v["price"], 200, 300), "kernel"),
    "in_interval": (lambda q, c: q.In(c["price"], [5, 6, 7, 8]),
                    lambda v: np.isin(v["price"], [5, 6, 7, 8]), "kernel"),
    "in_window": (lambda q, c: q.In(c["price"], [0, 2, 4, 6]),
                  lambda v: np.isin(v["price"], [0, 2, 4, 6]), "kernel"),
    "in_ortree": (lambda q, c: q.In(c["price"], [3, 70, 141, 200, 262, 333, 400, 511]),
                  lambda v: np.isin(v["price"], [3, 70, 141, 200, 262, 333, 400, 511]), "kernel"),
    "in_compare": (lambda q, c: q.In(c["price"], [7, 450]),
                   lambda v: np.isin(v["price"], [7, 450]), "kernel"),
    "in_domain": (lambda q, c: q.In(c["status"], [1, 4, 9, 0, 40]),
                  lambda v: np.isin(v["status"], [1, 4, 9, 0, 40]), "kernel"),
    "or_one_member": (lambda q, c: q.Or(q.Eq(c["status"], 1), q.In(c["status"], [4, 9])),
                      lambda v: np.isin(v["status"], [1, 4, 9]), "kernel"),
    "zoned_range": (lambda q, c: q.Range(c["sorted"], 0, 40),
                    lambda v: v["sorted"] < 40, "kernel"),
    "zoned_no_zone": (lambda q, c: q.Range(c["sorted"], 512, 1000),
                      lambda v: np.zeros(SORTED_N, bool), "kernel"),
    "or_of_ranges": (
        lambda q, c: q.Or(q.Range(c["price"], 0, 50), q.Range(c["price"], 300, 350)),
        lambda v: (v["price"] < 50) | _between(v["price"], 300, 350), "popcount"),
    "or_of_two_rows": (lambda q, c: q.Or(q.Eq(c["price"], 9), q.Eq(c["region"], 7)),
                       lambda v: (v["price"] == 9) | (v["region"] == 7), "popcount"),
    "not_conj": (
        lambda q, c: q.Not(q.And(q.Eq(c["price"], 3), q.Eq(c["region"], 4),
                                 q.Eq(c["status"], 5))),
        lambda v: ~((v["price"] == 3) & (v["region"] == 4) & (v["status"] == 5)), "popcount"),
    "two_groups": (
        lambda q, c: q.And(*[q.Range(c[f"w{i}"], 1, (1 << w) - 1)
                             for i, w in enumerate(WIDE_WIDTHS)]),
        lambda v: np.logical_and.reduce([_between(v[f"w{i}"], 1, (1 << w) - 1)
                                         for i, w in enumerate(WIDE_WIDTHS)]), "popcount"),
    "empty_in": (lambda q, c: q.In(c["price"], []), lambda v: np.zeros(N, bool), "popcount"),
    "empty_or": (lambda q, c: q.Or(q.Or(), q.In(c["status"], [])),
                 lambda v: np.zeros(N, bool), "popcount"),
    "empty_intersection": (
        lambda q, c: q.And(q.Range(c["price"], 10, 200), q.Range(c["price"], 300, 400),
                           q.Eq(c["region"], 3)),
        lambda v: np.zeros(N, bool), "popcount"),
}


@pytest.mark.parametrize("shape", sorted(ROUTES))
def test_count_from_the_kernel_that_wrote_the_bits(routed_table, shape):
    """evaluate's count is the writing kernel's where the words reach it
    unchanged, the popcount after a combine; either way it equals the
    popcount of the words, the JAX package's count and numpy's."""
    build, predicate, route = ROUTES[shape]
    values, jcols, tcols = routed_table
    texpr = build(tq, tcols)
    zonemaps = None
    if shape.startswith("zoned"):
        col = tcols["sorted"]
        zonemaps = {id(col): tzonemap.build_zonemap(col, zone_b1=8)}
    before = profiling.counters()
    tbits, tcount = tq.evaluate(texpr, zonemaps=zonemaps)
    after = profiling.counters()
    rose = {r: after.get(f"query.count.{r}", 0) - before.get(f"query.count.{r}", 0)
            for r in ("kernel", "popcount")}
    assert rose == {"kernel": int(route == "kernel"), "popcount": int(route == "popcount")}
    assert tcount.dtype == torch.int64 and tcount.ndim == 0
    jbits, jcount = jq.evaluate(build(jq, jcols), interpret=True)
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    expect = predicate(values)
    n = expect.shape[0]
    np.testing.assert_array_equal(tbitvector.to_bool(tbits, n).numpy(), expect)
    assert int(tcount) == int(tbitvector.popcount(tbits)) == int(jcount) == int(expect.sum())
    if shape == "zoned_range":
        # the pruned scan ran on its block rows in place, not the whole column
        _, span = tzonemap.prune_span(zonemaps[id(tcols["sorted"])], 0, 40)
        assert span * 2 <= tcols["sorted"].tiles.shape[1]
