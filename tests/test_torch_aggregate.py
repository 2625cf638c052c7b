"""The port's aggregate path against the JAX package: keyed SUM/COUNT (the
compare and both bit-plane tiers), MIN/MAX, the masked aggregate over a
``query.evaluate`` bitvector, and the aggregate planner.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_aggregate.py
does, and its partials are finalized with its own ``finalize_sums`` and
``finalize_minmax``.  Both get the same inputs from a numpy seed at b1 = 8
shapes (ragged n, key 0 over the zero padding, duplicate and out-of-domain
keys) and must agree exactly (integers, tolerance 0).  The one place they
differ, the key 0xFFFFFFFF in the JAX package's compare and MIN/MAX
tiers, has its own test.  Each interpret-mode call compiles per shape and
key count, so there are few of them.  The CUDA kernels are held against
the plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import bitvector as jbitvector
from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu.ops import aggregate as jagg
from shared_simd_scan_tpu.ops import oracle as joracle
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import query as tq
from shared_simd_scan_tpu_torch.ops import aggregate as tagg
from shared_simd_scan_tpu_torch.ops import oracle as toracle

torch.set_num_threads(1)

# (predicate width, measure width): wm <= 16, wm > 16 (the reference's
# 16-bit split), wm = 31, wp = 31 and wp = 1
PAIRS = [(9, 9), (9, 16), (5, 17), (9, 31), (31, 12), (1, 20)]
TOP = 0xFFFFFFFF


def _keys_t(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32).copy())


def _table(wp, wm, seed):
    """Two columns of one ragged n (B1 = 8), packed by both packages."""
    rng = np.random.default_rng(seed)
    n = 20_000 + 37 * wp + wm
    p = rng.integers(0, 1 << wp, n, dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 1 << wm, n, dtype=np.uint64).astype(np.uint32)
    jcols = (jlayout.pack_device(p, wp), jlayout.pack_device(m, wm))
    tcols = (tlayout.pack_device(p, wp, device="cpu"), tlayout.pack_device(m, wm, device="cpu"))
    return n, p, m, jcols, tcols


def _keys(wp, p):
    """Key 0 (its padding trap), a duplicated present key and the first
    key out of the domain."""
    return np.asarray([0, p[5], p[5], 1 << wp], np.uint32)


def _truth(p, m, keys):
    sums = np.array([m[p == key].astype(np.int64).sum() for key in keys], np.int64)
    counts = np.array([(p == key).sum() for key in keys], np.int64)
    return sums, counts


def _assert_sums(tout, jcounts, jslo, jshi, p, m, keys):
    tcounts, tsums = tout
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))
    np.testing.assert_array_equal(tsums.numpy(), jagg.finalize_sums(jslo, jshi).astype(np.int64))
    sums, counts = _truth(p, m, keys)
    np.testing.assert_array_equal(tsums.numpy(), sums)
    np.testing.assert_array_equal(tcounts.numpy(), counts)


@pytest.mark.parametrize("wp,wm", PAIRS)
def test_aggregate_scan_tiles_matches_jax(wp, wm):
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 10 * wp + wm)
    keys = _keys(wp, p)
    jout = jagg.aggregate_scan_tiles(jp.tiles, jm.tiles, jnp.asarray(keys), wp, wm, n,
                                     interpret=True)
    tout = tagg.aggregate_scan_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
    _assert_sums(tout, *jout, p, m, keys)


@pytest.mark.parametrize("wp,wm", PAIRS)
def test_minmax_scan_tiles_matches_jax(wp, wm):
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 40 * wp + wm)
    keys = _keys(wp, p)
    jcounts, jmins, jmaxs = jagg.minmax_scan_tiles(jp.tiles, jm.tiles, jnp.asarray(keys), wp, wm,
                                                   n, interpret=True)
    jmn, jmx = jagg.finalize_minmax(jmins, jmaxs, jcounts, wm)
    tcounts, tmn, tmx = tagg.minmax_scan_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))
    np.testing.assert_array_equal(tmn.numpy(), jmn.astype(np.int64))
    np.testing.assert_array_equal(tmx.numpy(), jmx.astype(np.int64))
    for j, key in enumerate(keys):
        sel = m[p == key]
        assert int(tcounts[j]) == sel.size
        assert int(tmn[j]) == (int(sel.min()) if sel.size else 1 << wm)
        assert int(tmx[j]) == (int(sel.max()) if sel.size else 0)


# MIN/MAX's key lookup across predicate and measure widths (the byte table
# up to wp 16, the window or search past it on the card)
MINMAX_WP = [1, 5, 16, 17, 20, 31]
MINMAX_WM = [1, 20, 31]


def _minmax_case(wp, wm, seed):
    """Two ragged columns (B1 = 8) on the CPU, a wm = 31 value equal to
    0x7FFFFFFF, and keys: 0 (over the padding), a duplicated present key,
    the key of that 0x7FFFFFFF value, an absent in-domain key where one
    exists (an empty group), 2^wp and 0xFFFFFFFF, then present keys up to
    32."""
    rng = np.random.default_rng(seed)
    n = 20_000 + 37 * wp + wm
    p = rng.integers(0, 1 << wp, n, dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 1 << wm, n, dtype=np.uint64).astype(np.uint32)
    m[7] = (1 << wm) - 1
    absent = np.setdiff1d(np.arange(min(1 << wp, 1 << 16), dtype=np.uint32), p)[:1]
    keys = np.concatenate([[0, p[5], p[5], p[7]], absent, [1 << wp, TOP],
                           p[rng.integers(0, n, 32)]])[:32].astype(np.uint32)
    return n, p, m, keys


def _minmax_truth(p, m, keys, wm):
    counts, mins, maxs = [], [], []
    for key in keys:
        sel = m[p == key].astype(np.int64)
        counts.append(sel.size)
        mins.append(int(sel.min()) if sel.size else 1 << wm)
        maxs.append(int(sel.max()) if sel.size else 0)
    return counts, mins, maxs


@pytest.mark.parametrize("wm", MINMAX_WM)
@pytest.mark.parametrize("wp", MINMAX_WP)
def test_minmax_plain_matches_numpy_across_widths(wp, wm):
    # the whole key set (k 32 with its edges) at block_offset 0 and 3: the
    # last three blocks' values, and the padding, drop out
    n, p, m, keys = _minmax_case(wp, wm, 90 * wp + wm)
    tp = tlayout.pack_device(p, wp, device="cpu")
    tm = tlayout.pack_device(m, wm, device="cpu")
    for off in (0, 3):
        cut = n - 32 * off
        got = tagg.minmax_scan_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n, off)
        want = _minmax_truth(p[:cut], m[:cut], keys, wm)
        for g, w in zip(got, want):
            assert g.tolist() == w, (off, keys.tolist())
    if wm == 31:
        assert int(got[0][3]) > 0 and int(got[2][3]) == 0x7FFFFFFF


@pytest.mark.parametrize("wp,wm,off", [(1, 31, 0), (17, 20, 3), (31, 1, 2)])
def test_minmax_plain_matches_jax_across_widths(wp, wm, off):
    # the edge keys of _minmax_case (k 6, 0xFFFFFFFF left out: the JAX
    # kernel counts padding there), against the JAX kernel in interpret mode
    n, p, m, keys = _minmax_case(wp, wm, 90 * wp + wm)
    keys = keys[:7][keys[:7] != TOP]
    jp, jm = jlayout.pack_device(p, wp), jlayout.pack_device(m, wm)
    tp = tlayout.pack_device(p, wp, device="cpu")
    tm = tlayout.pack_device(m, wm, device="cpu")
    jcounts, jmins, jmaxs = jagg.minmax_scan_tiles(jp.tiles, jm.tiles, jnp.asarray(keys), wp, wm,
                                                   n, interpret=True, block_offset=off)
    jmn, jmx = jagg.finalize_minmax(jmins, jmaxs, jcounts, wm)
    tcounts, tmn, tmx = tagg.minmax_scan_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n, off)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))
    np.testing.assert_array_equal(tmn.numpy(), jmn.astype(np.int64))
    np.testing.assert_array_equal(tmx.numpy(), jmx.astype(np.int64))
    cut = n - 32 * off
    assert [t.tolist() for t in (tcounts, tmn, tmx)] == list(_minmax_truth(p[:cut], m[:cut], keys,
                                                                           wm))


def test_minmax_plain_on_contention_columns():
    # every row on one key, 90% on one key, sorted runs (the card's warp
    # hot slot), and a measure that falls with the row index (every value
    # a new minimum)
    n = 8 * 1024 + 77
    rng = np.random.default_rng(11)
    uniform = rng.integers(0, 32, n).astype(np.uint32)
    columns = {"constant": np.full(n, 3, np.uint32),
               "skewed": np.where(rng.random(n) < 0.9, 3, uniform).astype(np.uint32),
               "sorted": np.sort(uniform)}
    m = ((1 << 20) - 1 - np.arange(n)).astype(np.uint32)
    tm = tlayout.pack_device(m, 20, device="cpu")
    keys = np.arange(32, dtype=np.uint32)
    for label, p in columns.items():
        tp = tlayout.pack_device(p, 5, device="cpu")
        got = tagg.minmax_scan_tiles(tp.tiles, tm.tiles, _keys_t(keys), 5, 20, n)
        for g, w in zip(got, _minmax_truth(p, m, keys, 20)):
            assert g.tolist() == w, label


@pytest.mark.parametrize("wp,wm", PAIRS)
def test_masked_aggregate_tiles_matches_jax(wp, wm):
    n, p, m, (_, jm), (_, tm) = _table(wp, wm, 50 * wp + wm)
    mask = (p % 3 == 1) if wp > 1 else (p == 1)
    jbits = jbitvector.from_bool(jnp.asarray(mask))
    row = jagg.bits_from_canonical(jbits, jm.tiles.shape[1])
    jcount, jslo, jshi = jagg.masked_aggregate_tiles(jm.tiles, row, wm, n, interpret=True)
    trow = tagg.bits_from_canonical(torch.from_numpy(np.asarray(jbits).view(np.int32).copy()), 8)
    np.testing.assert_array_equal(trow.numpy(), np.asarray(row).view(np.int32))
    tcount, tsum = tagg.masked_aggregate_tiles(tm.tiles, trow, wm, n)
    assert int(tcount) == int(jcount) == int(mask.sum())
    assert int(tsum) == int(jagg.finalize_sums(jslo, jshi)[0]) == int(m[mask].astype(np.int64).sum())


def test_key_0xffffffff_counts_padding_in_the_jax_compare_tiers_only():
    # The JAX compare and MIN/MAX kernels rewrite padding predicates to the
    # sentinel 0xFFFFFFFF, so that key counts every padding slot there; its
    # bit-plane tier and every tier of the port mask with the validity word.
    wp, wm, n = 4, 4, 100
    p = np.arange(n, dtype=np.uint32) % 16
    m = (np.arange(n, dtype=np.uint32) * 7) % 16
    jp, jm = jlayout.pack_device(p, wp), jlayout.pack_device(m, wm)
    tp, tm = tlayout.pack_device(p, wp, device="cpu"), tlayout.pack_device(m, wm, device="cpu")
    b1 = jp.tiles.shape[1]
    keys = np.asarray([3, TOP], np.uint32)
    padding = b1 * 128 * 32 - n
    jc, _, _ = jagg.aggregate_scan_tiles(jp.tiles, jm.tiles, jnp.asarray(keys), wp, wm, n,
                                         interpret=True)
    assert int(jc[1]) == padding == 32668
    jc, jmins, jmaxs = jagg.minmax_scan_tiles(jp.tiles, jm.tiles, jnp.asarray(keys), wp, wm, n,
                                              interpret=True)
    jmn, jmx = jagg.finalize_minmax(jmins, jmaxs, jc, wm)
    assert int(jc[1]) == padding and int(jmn[1]) == 0 and int(jmx[1]) == 0
    jc, _, _ = jagg.aggregate_bitplane_static_tiles(jp.tiles, jm.tiles, keys, wp, wm, n,
                                                    interpret=True)
    assert int(jc[1]) == 0

    hits = int((p == 3).sum())
    for fn in (tagg.aggregate_scan_tiles, tagg.aggregate_bitplane_tiles):
        tc, ts = fn(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
        assert tc.tolist() == [hits, 0] and int(ts[1]) == 0
    tc, ts = tagg.aggregate_bitplane_static_tiles(tp.tiles, tm.tiles, keys, wp, wm, n)
    assert tc.tolist() == [hits, 0] and int(ts[1]) == 0
    tc, tmn, tmx = tagg.minmax_scan_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
    assert tc.tolist() == [hits, 0]
    assert int(tmn[1]) == 1 << wm and int(tmx[1]) == 0
    assert int(tmn[0]) == int(m[p == 3].min()) and int(tmx[0]) == int(m[p == 3].max())


def test_sums_are_exact_past_32_bits():
    # wm = 31, every value 2^31 - 1 and every row matching: 32,000 rows sum
    # to ~6.9e13, far past 2^32, in every tier
    wp, wm, n = 3, 31, 32_000
    p = np.full(n, 5, np.uint32)
    m = np.full(n, (1 << 31) - 1, np.uint32)
    tp, tm = tlayout.pack_device(p, wp, device="cpu"), tlayout.pack_device(m, wm, device="cpu")
    keys = [5, 0]
    want = [n * ((1 << 31) - 1), 0]
    for fn in (tagg.aggregate_scan_tiles, tagg.aggregate_bitplane_tiles):
        tc, ts = fn(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
        assert ts.tolist() == want and tc.tolist() == [n, 0]
    tc, ts = tagg.aggregate_bitplane_static_tiles(tp.tiles, tm.tiles, keys, wp, wm, n)
    assert ts.tolist() == want and tc.tolist() == [n, 0]
    tc, tmn, tmx = tagg.minmax_scan_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
    assert tmn.tolist() == [(1 << 31) - 1, 1 << 31] and tmx.tolist() == [(1 << 31) - 1, 0]
    row = tagg.bits_from_canonical(tbitvector.from_bool(torch.ones(n, dtype=torch.bool)), 8)
    tcount, tsum = tagg.masked_aggregate_tiles(tm.tiles, row, wm, n)
    assert int(tcount) == n and int(tsum) == want[0]


def test_transpose_ops_match_jax():
    assert [tagg._transpose_ops(w) for w in range(1, 32)] == \
        [jagg._transpose_ops(w) for w in range(1, 32)]


@pytest.mark.parametrize("wp", range(1, 32))
def test_pick_aggregate_tier_matches_jax(wp):
    """Widths 1-31 x k 1-32 x spread, clustered and duplicate key sets, the
    measure width cycling through 1-31; runtime keys are priced by k."""
    rng = np.random.default_rng(wp)
    dom = 1 << wp
    for k in range(1, 33):
        wm = (7 * wp + k) % 31 + 1
        lo = int(rng.integers(0, dom))
        sets = (rng.integers(0, dom, size=k),
                (lo + rng.integers(0, 48, size=k)) % dom,
                np.repeat(rng.integers(0, dom, size=(k + 1) // 2), 2)[:k])
        for keys in sets:
            keys = keys.astype(np.uint32)
            assert tagg.aggregate_bitplane_cost(wp, wm, keys) == \
                jagg.aggregate_bitplane_cost(wp, wm, keys)
            assert tagg.pick_aggregate_tier(wp, wm, keys) == jagg.pick_aggregate_tier(wp, wm, keys)
            assert tagg.pick_aggregate_tier(wp, wm, _keys_t(keys)) == \
                jagg.pick_aggregate_tier(wp, wm, keys)
        assert tagg.aggregate_bitplane_cost(wp, wm, k) == jagg.aggregate_bitplane_cost(wp, wm, k)
        assert tagg._agg_compare_cost(wp, wm, k) == jagg._agg_compare_cost(wp, wm, k)


def test_reference_key_sets_take_the_expected_tiers():
    # the full-size sets of chip_smoke.py's aggregate phase
    assert tagg.pick_aggregate_tier(5, 20, list(range(32))) == "bitplane"
    assert tagg.pick_aggregate_tier(9, 20, [3]) == "compare"
    assert tagg.aggregate_bitplane_cost(5, 20, 8) < tagg._agg_compare_cost(5, 20, 8)
    assert tagg.aggregate_bitplane_cost(9, 20, 2) > tagg._agg_compare_cost(9, 20, 2)
    # A9: 16 CUDA keys of the 20-bit predicate take the runtime bit-plane tier
    assert tagg.aggregate_bitplane_cost(20, 9, 16) < tagg._agg_compare_cost(20, 9, 16)
    assert tagg.pick_aggregate_tier(9, 16, [1]) == jagg.pick_aggregate_tier(9, 16, [1]) == "compare"


def test_minmax_scan_device_matches_jax():
    wp, wm = 9, 31
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 71)
    keys = _keys(wp, p)
    jmn, jmx, jc = jagg.minmax_scan_device(jp, jm, keys, interpret=True)
    tmn, tmx, tc = tagg.minmax_scan_device(tp, tm, keys)
    np.testing.assert_array_equal(tmn.numpy(), jmn.astype(np.int64))
    np.testing.assert_array_equal(tmx.numpy(), jmx.astype(np.int64))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))


def test_masked_aggregate_over_the_demo_where_clause():
    # SELECT SUM(revenue), COUNT(*) WHERE <the analytics demo's clause>
    rng = np.random.default_rng(7)
    n = 5000
    widths = {"price": 9, "region": 5, "status": 4, "revenue": 20}
    v = {name: rng.integers(0, 1 << w, n, dtype=np.uint64).astype(np.uint32)
         for name, w in widths.items()}
    jc = {name: jlayout.pack_device(v[name], w) for name, w in widths.items()}
    tc = {name: tlayout.pack_device(v[name], w, device="cpu") for name, w in widths.items()}

    def demo(q, c):
        return q.And(q.Range(c["price"], 100, 400), q.Range(c["region"], 2, 10),
                     q.Or(q.In(c["status"], [1, 4, 9]), q.Eq(c["status"], 0)))

    jbits, _ = jq.evaluate(demo(jq, jc), interpret=True)
    jsum, jcount = jagg.masked_aggregate_device(jc["revenue"], jbits, interpret=True)
    tbits, tcount_q = tq.evaluate(demo(tq, tc))
    tsum, tcount = tagg.masked_aggregate_device(tc["revenue"], tbits)
    expect = ((v["price"] >= 100) & (v["price"] < 400) & (v["region"] >= 2) & (v["region"] < 10)
              & (np.isin(v["status"], [1, 4, 9]) | (v["status"] == 0)))
    assert int(tcount) == int(jcount) == int(tcount_q) == int(expect.sum())
    assert int(tsum) == int(jsum) == int(v["revenue"][expect].astype(np.int64).sum())


def test_oracle_aggregate_scan_matches_jax():
    wp, wm = 9, 20
    n, p, m, _, _ = _table(wp, wm, 72)
    keys = np.arange(16, dtype=np.uint32)
    jsums, jcounts = joracle.aggregate_scan(jlayout.pack(p, wp), jlayout.pack(m, wm), keys)
    tsums, tcounts = toracle.aggregate_scan(tlayout.pack(p, wp, device="cpu"),
                                            tlayout.pack(m, wm, device="cpu"), keys)
    np.testing.assert_array_equal(tsums.numpy(), jsums.astype(np.int64))
    np.testing.assert_array_equal(tcounts.numpy(), jcounts.astype(np.int64))


def test_bits_from_canonical_matches_jax():
    words = np.random.default_rng(1).integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    row = tagg.bits_from_canonical(torch.from_numpy(words.view(np.int32)), 8)
    np.testing.assert_array_equal(row.numpy().view(np.uint32),
                                  np.asarray(jagg.bits_from_canonical(jnp.asarray(words), 8)))
    with pytest.raises(ValueError, match="do not fit"):
        tagg.bits_from_canonical(torch.zeros(8 * 128 + 1, dtype=torch.int32), 8)


def test_refusals():
    wp, wm = 9, 9
    n, p, m, _, (tp, tm) = _table(wp, wm, 73)
    for keys in (np.arange(40, dtype=np.uint32), np.zeros(0, np.uint32)):
        with pytest.raises(ValueError, match="1 <= k <= 32"):
            tagg.aggregate_scan_device(tp, tm, keys)
        with pytest.raises(ValueError, match="1 <= k <= 32"):
            tagg.minmax_scan_device(tp, tm, keys)
        with pytest.raises(ValueError, match="1 <= k <= 32"):
            tagg.aggregate_bitplane_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
        with pytest.raises(ValueError, match="1 <= k <= 32"):
            tagg.aggregate_bitplane_static_tiles(tp.tiles, tm.tiles, keys, wp, wm, n)
    short = tlayout.pack_device(m[: n - 100], wm, device="cpu")
    with pytest.raises(ValueError, match="column lengths differ"):
        tagg.aggregate_scan_device(tp, short, [1, 2])
    with pytest.raises(ValueError, match="column lengths differ"):
        tagg.minmax_scan_device(tp, short, [1, 2])
    other = tlayout.pack_device(np.zeros(40_000, np.uint32), wm, device="cpu")
    with pytest.raises(ValueError, match="share n"):
        tagg.aggregate_scan_tiles(tp.tiles, other.tiles, _keys_t([1]), wp, wm, n)
    with pytest.raises(TypeError):
        tagg.aggregate_scan_tiles(tp.tiles, tm.tiles, torch.tensor([1]), wp, wm, n)  # int64 keys
    with pytest.raises(ValueError, match="bits"):
        tagg.masked_aggregate_tiles(tm.tiles, torch.zeros((4, 128), dtype=torch.int32), wm, n)
