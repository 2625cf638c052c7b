"""The port's IN-list member scan against the JAX package: the seven kernel
bodies' plain versions, the planners and the dispatcher.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, called directly as
tests/test_member.py calls them.  Both get the same columns from a numpy
seed and must agree bit for bit (words and counts, tolerance 0).  The
planners are pure Python and must make the same decision on every key set
of the sweep.  The CUDA kernels are held against the plain versions in
test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import member as jmember
from shared_simd_scan_tpu.ops import oracle as joracle
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import member as tmember
from shared_simd_scan_tpu_torch.ops import oracle as toracle
from shared_simd_scan_tpu_torch.ops import scan as tscan
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 4241  # ragged: the last block holds 17 values, then padding blocks


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _t32(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.uint32).view(np.int32).copy())


def _column(width, n, seed):
    """(values, JAX DeviceColumn, port DeviceColumn crossed with from_jax_numpy)."""
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n, dtype=np.uint64)
    values = values.astype(np.uint32)
    jdev = jlayout.pack_device(values, width)
    tdev = tlayout.from_jax_numpy(width, n, np.asarray(jdev.tiles), "cpu")
    return values, jdev, tdev


def _assert_same(tout, jout):
    np.testing.assert_array_equal(_u32(tout[0]), np.asarray(jout[0]))
    assert int(tout[1]) == int(jout[1])


def _expect_count(values, keys) -> int:
    return int(np.isin(values, np.asarray(keys, np.uint32)).sum())


def _keys(width, k, seed, extra=()):
    """k keys drawn from the domain, then key 0 (over padding), a duplicate
    and ``extra`` (out-of-domain keys)."""
    dom = 1 << width
    keys = np.random.default_rng(seed).integers(0, dom, size=k).tolist()
    return keys[: max(k - 2, 1)] + [0, keys[0]][: k - max(k - 2, 1)] + list(extra)


# ---------------------------------------------------------------------------
# the seven kernel bodies, called directly
# ---------------------------------------------------------------------------

COMPARE_CASES = [(1, 3, ()), (9, 7, (512, 0xFFFFFFFF)), (31, 8, ())]


@pytest.mark.parametrize("width,k,extra", COMPARE_CASES)
def test_member_compare_tiles_matches_jax(width, k, extra):
    values, jdev, tdev = _column(width, N, seed=width)
    keys = _keys(width, k, width, extra)
    jout = jmember._member_compare_tiles(jdev.tiles, jnp.asarray(keys, jnp.uint32).reshape(-1, 1),
                                         width, N, None, True, 0)
    tout = tmember._member_compare_tiles(tdev.tiles, _t32(keys), width, N)
    _assert_same(tout, jout)
    assert int(tout[1]) == _expect_count(values, keys)


def test_member_chunked_compare_tiles_matches_jax():
    # chunks of 8 keys: the same body as the dispatcher's 32, a quarter of
    # its interpret-mode compile
    width, k = 17, 24
    values, jdev, tdev = _column(width, N, seed=width + 1)
    keys = _keys(width, k - 3, width, (1 << width, 1 << 31)) + [0xFFFFFFFF]  # padding key
    jout = jmember._member_chunked_compare_tiles(
        jdev.tiles, jnp.asarray(keys, jnp.uint32).reshape(-1, 1), width, N, None, True, 8, 7)
    tout = tmember._member_chunked_compare_tiles(tdev.tiles, _t32(keys), width, N, 8, 7)
    _assert_same(tout, jout)


@pytest.mark.parametrize("width,k", [(2, 32), (5, 96), (31, 64)])
def test_member_chunked_compare_tiles_matches_numpy(width, k):
    values, _, tdev = _column(width, N, seed=width + 1)
    keys = _keys(width, k - 2, width, (1 << width, 0xFFFFFFFF))
    _, count = tmember._member_chunked_compare_tiles(tdev.tiles, _t32(keys), width, N, 32)
    assert int(count) == _expect_count(values, keys)


def _windows(width, keys, pad_to=None):
    bases, pops = jmember.member_window_plan(np.asarray(keys, np.uint32))
    win = np.stack([bases, pops], axis=1).astype(np.uint32)
    if pad_to is not None:
        win = np.concatenate([win, np.zeros((pad_to - win.shape[0], 2), np.uint32)])
    return win


@pytest.mark.parametrize("width", [1, 9, 31])
def test_member_window_tiles_matches_jax(width):
    values, jdev, tdev = _column(width, N, seed=width + 2)
    dom = 1 << width
    keys = sorted({v % dom for v in (0, 2, 4, 6, 31, 33, 64, 71, 95)}) + [dom + 3]
    win = _windows(width, keys)
    gateless = jscan.shift_saturates(interpret=True)
    jout = jmember._member_window_tiles(jdev.tiles, jnp.asarray(win), width, N, None, True,
                                        gateless, 0)
    tout = tmember._member_window_tiles(tdev.tiles, _t32(win), width, N)
    _assert_same(tout, jout)
    assert int(tout[1]) == _expect_count(values, keys)


def _clustered(width, nwin, values):
    """Keys in ``nwin`` windows of the domain, and one value of the column."""
    rng = np.random.default_rng(width)
    bases = np.sort(rng.choice(1 << (width - 5), size=nwin, replace=False)) * 32
    return np.concatenate([b + np.arange(0, 8, 3) for b in bases]).tolist() + [int(values[5])]


def test_member_chunked_window_tiles_matches_jax():
    # chunks of 4 windows (the dispatcher's are 32), for a short compile
    width, nwin = 16, 10
    values, jdev, tdev = _column(width, N, seed=width + 3)
    keys = _clustered(width, nwin, values)
    win = _windows(width, keys, pad_to=12)
    gateless = jscan.shift_saturates(interpret=True)
    jout = jmember._member_chunked_window_tiles(jdev.tiles, jnp.asarray(win), width, N, None,
                                                True, 4, gateless, 0)
    tout = tmember._member_chunked_window_tiles(tdev.tiles, _t32(win), width, N, 4)
    _assert_same(tout, jout)
    assert int(tout[1]) == _expect_count(values, keys) >= 1


@pytest.mark.parametrize("width,nwin", [(6, 2), (12, 33), (31, 70)])
def test_member_chunked_window_tiles_matches_numpy(width, nwin):
    values, _, tdev = _column(width, N, seed=width + 3)
    keys = _clustered(width, nwin, values)
    win = _windows(width, keys, pad_to=-(-(nwin + 1) // 32) * 32)
    _, count = tmember._member_chunked_window_tiles(tdev.tiles, _t32(win), width, N, 32)
    assert int(count) == _expect_count(values, keys) >= 1


@pytest.mark.parametrize("width,k", [(1, 3), (7, 40)])
def test_member_domain_tiles_matches_jax(width, k):
    values, jdev, tdev = _column(width, N, seed=width + 4)
    keys = _keys(width, k, width + 4, (1 << width, 40, 0xFFFFFFFF))
    table = jmember.domain_table(np.asarray(keys, np.uint32), width)
    jout = jmember._member_domain_tiles(jdev.tiles, table, width, N, None, True, 0)
    tout = tmember._member_domain_tiles(tdev.tiles, _t32(keys), width, N)
    _assert_same(tout, jout)
    # the port's table is the JAX package's, bit for bit (keys past it dropped)
    np.testing.assert_array_equal(_u32(tmember.domain_table(_t32(keys), width)),
                                  np.asarray(table))
    np.testing.assert_array_equal(_u32(tmember.domain_table(keys, width)), np.asarray(table))


@pytest.mark.parametrize("width,k", [(4, 9), (12, 300), (16, 1000)])
def test_member_domain_tiles_matches_numpy(width, k):
    values, _, tdev = _column(width, N, seed=width + 4)
    keys = _keys(width, k, width + 4, (1 << width, 0xFFFFFFFF))
    _, count = tmember._member_domain_tiles(tdev.tiles, _t32(keys), width, N)
    assert int(count) == _expect_count(values, keys)


ORTREE_CASES = [
    # width, keys
    (1, [1]),
    (8, list(range(1, 256, 2)) + list(range(0, 256, 2))),  # the whole domain: all ones
    (9, list(range(512))),                                 # the whole domain at width 9
    (9, [3, 70, 141, 200, 262, 333, 400, 511, 0]),         # key 0 over padding
    (16, "random40"),                                      # the widest bitmap
    (17, "random40"),                                      # the narrowest search
    (20, "random64"),
    (31, "random60"),
]


@pytest.mark.parametrize("width,keys", ORTREE_CASES)
def test_member_ortree_tiles_matches_jax(width, keys):
    # the port's wrapper also gets a duplicate and keys past the domain,
    # which it drops; the JAX body takes the in-domain set, sorted
    values, jdev, tdev = _column(width, N, seed=width + 5)
    if isinstance(keys, str):
        k = int(keys[len("random"):])
        keys = values[np.random.default_rng(6).integers(0, N, size=k)].tolist()
    pats = tuple(sorted(set(keys)))
    jout = jmember._member_ortree_tiles(jdev.tiles, width, N, None, True, pats, 0)
    tout = tmember._member_ortree_tiles(tdev.tiles, width, N,
                                        keys + [keys[0], 1 << width, 0xFFFFFFFF])
    _assert_same(tout, jout)
    assert int(tout[1]) == _expect_count(values, keys)


SET_TABLE_CASES = [
    # width, keys (drawn: half of them past the domain, one duplicate)
    (1, [1, 1, 2, 0xFFFFFFFF]),
    (9, list(range(512))),                        # the whole domain
    (9, [3, 70, 70, 141, 511, 512, 1 << 20]),
    (16, "random300"),
    (17, "random300"),
    (20, "random64"),
    (20, []),
    (31, "random300"),
]


@pytest.mark.parametrize("width,keys", SET_TABLE_CASES)
def test_member_set_table_matches_jax(width, keys):
    # the lookup's table against the JAX package's domain bitmap (widths
    # up to 16) or its window plan (past 16), with the search table's
    # padding to a power of two
    if isinstance(keys, str):
        rng = np.random.default_rng(width)
        keys = rng.integers(0, 2 << width, size=int(keys[len("random"):])).tolist()
        keys[1] = keys[0]
    pats = tmember._ortree_patterns(width, keys)
    assert list(pats) == sorted({k for k in keys if k < 1 << width})
    table = _u32(tmember.member_set_table(width, pats))
    if width <= tmember.MAX_DOMAIN_WIDTH:
        want = np.asarray(jmember.domain_table(np.asarray(pats, np.uint32), width)).reshape(-1)
        np.testing.assert_array_equal(table, want)
        return
    bases, pops = jmember.member_window_plan(np.asarray(pats, np.uint32))
    p = table.shape[1]
    assert table.shape == (2, p) and p & (p - 1) == 0 and max(1, len(bases)) <= p
    assert p == 1 or p < 2 * len(bases)
    assert table[0, : len(bases)].tolist() == bases and table[1, : len(pops)].tolist() == pops
    assert (table[0, len(bases):] == 0xFFFFFFFF).all() and not table[1, len(bases):].any()


@pytest.mark.parametrize("width", [6, 20])
def test_member_ortree_tiles_out_of_domain_and_empty(width):
    # the bitmap (width 6) and the search table (width 20): a set wholly
    # past the domain, or empty, matches nothing (the JAX body reads an
    # empty set as the whole domain: a standing difference)
    values, _, tdev = _column(width, N, seed=11)
    dom = 1 << width
    for keys in ((dom, dom + 36, 0xFFFFFFFF), ()):
        bits, count = tmember._member_ortree_tiles(tdev.tiles, width, N, keys)
        assert int(count) == 0 and not bits.any()
    bits, count = tmember._member_ortree_tiles(tdev.tiles, width, N, (5, dom))
    assert int(count) == _expect_count(values, [5])


@pytest.mark.parametrize("width,k,krows", [(1, 5, 5), (9, 40, 32), (31, 8, 8), (17, 26, 8),
                                           (20, 30, 8), (31, 25, 8)])
def test_member_bitsliced_tiles_matches_jax(width, k, krows):
    values, jdev, tdev = _column(width, N, seed=width + 6)
    keys = _keys(width, k - 2, width + 6, (1 << width, 0xFFFFFFFF))
    keys += [0xFFFFFFFF] * ((-len(keys)) % krows)
    jout = jmember._member_bitsliced_tiles(jdev.tiles, jnp.asarray(keys, jnp.uint32).reshape(-1, 1),
                                           width, N, None, True, krows, 0)
    tout = tmember._member_bitsliced_tiles(tdev.tiles, _t32(keys), width, N, krows)
    _assert_same(tout, jout)
    assert int(tout[1]) == _expect_count(values, [v for v in keys if v < 1 << width])
    # the card's algorithm for this body: one lookup a value in the keys'
    # table (the chunk padding lies past 2^width and is dropped)
    table = tmember.member_operand_table_plain(width, keys=_t32(keys))
    row = tmember._bitmap_row_plain if width <= tmember.MAX_DOMAIN_WIDTH else \
        tmember._search_row_plain
    _assert_same(tmember._member_finish(row(tscan._block_values_plain(tdev.tiles, width), table),
                                        N, 0), jout)


# the bodies the traced-key rule can name, and the argument after ``n``
# (krows) of those that take one
_KEY_BODIES = ("domain", "bitsliced", "compare", "chunked_compare")


@pytest.mark.parametrize("width", [1, 5, 9, 12, 13, 16, 17, 20, 31])
def test_member_keys_tiles_picks_the_jax_traced_body(width, monkeypatch):
    # the port's keys path and the JAX traced-key rule name the same body
    # with the same padded key rows and chunk, for every k of the sweep;
    # the JAX side is traced abstractly with its bodies stubbed
    calls = {"jax": [], "port": []}

    def stub(side, name):
        def body(tiles, operand, width, n, *rest):
            rows = None if name == "domain" else int(operand.shape[0])
            krows = rest[-2] if name in ("bitsliced", "chunked_compare") else None
            calls[side].append((name, rows, krows))
            if side == "jax":
                return jnp.zeros(tiles.shape[1:], jnp.uint32), jnp.uint32(0)
            return torch.zeros(tuple(tiles.shape[1:]), dtype=torch.int32), torch.zeros(())
        return body

    for name in _KEY_BODIES:
        monkeypatch.setattr(jmember, f"_member_{name}_tiles", stub("jax", name))
        monkeypatch.setattr(tmember, f"_member_{name}_tiles", stub("port", name))
    tiles = torch.zeros((width, 8, 128), dtype=torch.int32)
    jtiles = jax.ShapeDtypeStruct((width, 8, 128), jnp.uint32)
    for k in (*range(1, 11), 16, 22, 23, 24, 31, 32, 33, 39, 40, 41, 64, 100, 256, 1025):
        keys = np.arange(k, dtype=np.uint32) * 37 % (1 << width)
        jax.eval_shape(lambda t, ks: jmember.member_scan_tiles(t, ks, width, N), jtiles,
                       jax.ShapeDtypeStruct((k,), jnp.uint32))
        tmember._member_keys_tiles(tiles, _t32(keys), width, N)
        assert len(calls["jax"]) == len(calls["port"]) == 1 and calls["jax"] == calls["port"], \
            (width, k, calls)
        calls["jax"].clear()
        calls["port"].clear()


def test_member_wrappers_refuse_what_the_kernels_cannot_take():
    tiles = torch.zeros((17, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="widths up to 16"):
        tmember._member_domain_tiles(tiles, _t32([1]), 17, 100)
    with pytest.raises(ValueError, match="whole chunks"):
        tmember._member_chunked_compare_tiles(tiles, _t32([1, 2, 3]), 17, 100, 2)
    with pytest.raises(ValueError):
        tmember._member_window_tiles(tiles, _t32([1, 2, 3]), 17, 100)
    with pytest.raises(ValueError, match="at least one key"):
        tmember.member_scan_tiles(tiles, [], 17, 100)
    with pytest.raises(TypeError):
        tmember._member_compare_tiles(tiles, torch.zeros(2, dtype=torch.int64), 17, 100)


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------


def _key_sets(width, k, rng):
    """Key sets of size k: spread, clustered, consecutive, duplicate, a
    third out of domain."""
    dom = 1 << width
    lo = int(rng.integers(0, dom))
    sets = {
        "spread": rng.integers(0, dom, size=k),
        "clustered": (lo + rng.integers(0, 48, size=k)) % dom,
        "consecutive": (lo + np.arange(k)) % (1 << 32),
        "duplicate": np.repeat(rng.integers(0, dom, size=(k + 1) // 2), 2)[:k],
        "out_of_domain": np.where(rng.random(k) < 0.3, dom + rng.integers(0, 1 << 20, size=k),
                                  rng.integers(0, dom, size=k)) % (1 << 32),
    }
    return {name: keys.astype(np.uint32) for name, keys in sets.items()}


@pytest.mark.parametrize("width", [1, 4, 9, 12, 16, 31])
def test_member_planners_match_jax(width):
    rng = np.random.default_rng(width)
    tiers = set()
    for k in [*range(1, 41), 48, 64, 100, 160]:
        for kind, keys in _key_sets(width, k, rng).items():
            tier = tmember.member_dispatch_tier(keys, width)
            assert tier == jmember.member_dispatch_tier(keys, width), (k, kind)
            tiers.add(tier)
            assert tmember.member_window_plan(keys) == jmember.member_window_plan(keys)
            assert tmember._consecutive_span(keys) == jmember._consecutive_span(keys)
            assert tmember.member_ortree_cost(width, keys) == jmember.member_ortree_cost(width, keys)
            ks = keys.tolist()
            assert tscan._static_dag_ops(width, ks, member=True) \
                == jscan._static_dag_ops(width, ks, member=True)
            assert tscan._static_dag_liveness(width, ks, member=True) \
                == jscan._static_dag_liveness(width, ks, member=True)
            if k <= 48:
                assert tscan._static_dag_liveness(width, ks) == jscan._static_dag_liveness(width, ks)
    for k in range(0, 300):
        assert tmember._bitsliced_member_wins(width, k) == jmember._bitsliced_member_wins(width, k)
    assert tmember._domain_member_cost(width) == jmember._domain_member_cost(width)
    assert "interval" in tiers and len(tiers) >= 3


def test_ortree_liveness_cap_matches_jax():
    # a wide spread set whose OR-tree keeps more than 256 vectors live is
    # priced out in both packages
    rng = np.random.default_rng(5)
    keys = np.array(sorted(set(rng.integers(0, 1 << 31, size=300).tolist())), np.uint32)
    assert tscan._static_dag_liveness(31, keys.tolist(), member=True) > tmember._ORTREE_MAX_LIVE
    assert tmember.member_ortree_cost(31, keys) == jmember.member_ortree_cost(31, keys) == 1 << 30
    assert tmember.member_dispatch_tier(keys, 31) == jmember.member_dispatch_tier(keys, 31)


def test_member_program_computes_the_plain_row():
    # the one-row OR-tree program, run as sss_bitsliced_static_scan runs
    # it, gives the plain OR-tree's words (full domain, empty set, spread)
    values, _, tdev = _column(7, N, seed=12)
    planes = tscan._bitplanes_plain(tdev.tiles, 7)
    for pats in ((), tuple(range(128)), (3, 9, 64, 100, 127), (0,)):
        prog, slots = tscan._member_program(7, pats)
        slot = dict(enumerate(planes))
        row = None
        for w0, w1 in prog.view(np.uint32).tolist():
            kind, target = w0 >> 30, w0 & 0x3FFFFFFF

            def operand(o):
                v = slot[o & 0x7FFF]
                return (~v & 0xFFFFFFFF) if o & 0x8000 else v

            if kind == tscan._AND:
                slot[target] = operand(w1 & 0xFFFF) & operand(w1 >> 16)
            elif kind == tscan._OR:
                slot[target] = operand(w1 & 0xFFFF) | operand(w1 >> 16)
            elif kind == tscan._OUT:
                row = operand(w1 & 0xFFFF)
            else:
                row = torch.zeros_like(planes[0])
        got = tmember._member_finish(row, N, 0)
        want = tmember._member_ortree_tiles_plain(tdev.tiles, 7, N, pats)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
        assert int(got[1]) == _expect_count(values, pats)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

HOST_SETS = [
    # width, keys, tier
    (9, list(range(100, 180)), "interval"),
    (9, [3, 4, 5, 6, 64, 65, 66, 67, 0], "window"),
    (9, [3, 70, 141, 200, 262, 333, 400, 511], "ortree"),
    (9, [600, 700, 800, 900, 1000, 1100, 1200], "ortree"),  # all out of domain: zeros
    (4, [1, 4, 9, 0, 40], "domain"),                # two windows cost more than the table
    (9, [7, 450], "compare"),
]


@pytest.mark.parametrize("width,keys,tier", HOST_SETS)
def test_member_scan_device_host_keys_match_jax(width, keys, tier):
    values, jdev, tdev = _column(width, N, seed=width + 7)
    assert tmember.member_dispatch_tier(np.asarray(keys, np.uint32), width) == tier
    jout = jmember.member_scan_device(jdev, np.asarray(keys, np.uint32), interpret=True)
    tout = tmember.member_scan_device(tdev, keys)
    _assert_same(tout, jout)
    assert int(tout[1]) == _expect_count(values, keys)


def test_member_dispatch_reaches_the_chunked_window():
    # 200 windows of 16 keys at width 31: the OR-tree is priced out by its
    # liveness and 20 per window undercuts the bit-sliced fold
    width = 31
    values, _, tdev = _column(width, N, seed=8)
    rng = np.random.default_rng(1)
    bases = rng.choice(1 << (width - 5), 200, replace=False) * 32
    keys = np.concatenate([b + rng.choice(32, 16, replace=False) for b in bases])
    keys = np.concatenate([keys, values[:5]]).astype(np.uint32)
    assert tmember.member_dispatch_tier(keys, width) == jmember.member_dispatch_tier(keys, width) \
        == "window"
    before = tmember._member_chunked_window_tiles_plain
    calls = []
    tmember._member_chunked_window_tiles_plain = lambda *a: calls.append(1) or before(*a)
    try:
        _, count = tmember.member_scan_device(tdev, keys)
    finally:
        tmember._member_chunked_window_tiles_plain = before
    assert calls == [1] and int(count) == _expect_count(values, keys) >= 5


def test_member_interval_run_ending_at_the_top_of_uint32():
    # hi = lo + k = 2^32 wraps to the span 2^32 - lo: nothing of a 9-bit
    # column matches.  (The JAX package raises OverflowError here.)
    values, _, tdev = _column(9, N, seed=3)
    keys = [0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF]
    assert tmember.member_dispatch_tier(np.asarray(keys, np.uint32), 9) == "interval"
    bits, count = tmember.member_scan_device(tdev, keys)
    assert int(count) == 0 and not bits.any()


RUNTIME_SETS = [
    # width, k: the runtime rule picks compare (k <= 6 at width 9),
    # bit-sliced (7..39) or the domain bitmap (>= 40); at width 13 the
    # domain is priced out and k = 100 takes bit-sliced in 4 chunks
    (9, 4, "compare"), (9, 16, "bitsliced"), (9, 64, "domain"), (13, 100, "bitsliced"),
]


@pytest.mark.parametrize("width,k,kernel", RUNTIME_SETS)
def test_member_runtime_keys_match_jax_traced(width, k, kernel, monkeypatch):
    values, jdev, tdev = _column(width, N, seed=width + k)
    keys = ((np.arange(k, dtype=np.uint32) * 37 + 11) % (1 << width)).astype(np.uint32)
    keys[1] = 1 << width  # out of domain

    @jax.jit
    def run(tiles, ks):
        return jmember.member_scan_tiles(tiles, ks, width, N, interpret=True)

    jout = run(jdev.tiles, jnp.asarray(keys))
    name = f"_member_{kernel}_tiles"
    real, calls = getattr(tmember, name), []

    def spy(*args):
        calls.append(kernel)
        return real(*args)

    monkeypatch.setattr(tmember, name, spy)
    tout = tmember._member_keys_tiles(tdev.tiles, _t32(keys), width, N)
    assert calls == [kernel]
    _assert_same(tout, jout)
    assert int(tout[1]) == _expect_count(values, [v for v in keys.tolist() if v < 1 << width])


def test_runtime_chunked_compare_matches_plain_compare():
    # no width sends runtime keys past 32 to the compare body (the
    # bit-sliced fold wins first), so the chunked compare is reached only
    # directly; its padded chunks equal one compare over the keys
    values, _, tdev = _column(31, N, seed=31)
    keys = values[:50].tolist() + [0, 5]
    padded = tmember._pad_keys(_t32(keys), 32)
    assert padded.shape[0] == 64 and int(padded[-1]) == -1
    a = tmember._member_chunked_compare_tiles(tdev.tiles, padded, 31, N, 32)
    b = tmember._member_compare_tiles(tdev.tiles, _t32(keys), 31, N)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1]) == _expect_count(values, keys)


def test_cpu_wrappers_launch_nothing():
    _, _, tdev = _column(9, 1000, seed=2)
    fns = [getattr(tmember, f"_member_{name}_tiles") for name in (
        "compare", "chunked_compare", "window", "chunked_window", "domain", "ortree", "bitsliced")]
    before = [profiling.launch_count(f) for f in fns]
    for keys in ([3, 70, 141, 200, 262, 333, 400, 511], [0, 2, 4, 6], list(range(10, 20))):
        tmember.member_scan_device(tdev, keys)
    for k in (4, 16, 64):
        tmember._member_keys_tiles(tdev.tiles, _t32(np.arange(k) * 7 % 512), 9, 1000)
    assert [profiling.launch_count(f) for f in fns] == before


@pytest.mark.parametrize("width", [1, 9, 31])
def test_member_oracle_matches_jax(width):
    # the ground truth of the member scan: duplicates count once, keys past
    # the domain match nothing
    values = np.random.default_rng(width).integers(0, 1 << width, size=N, dtype=np.uint64)
    values = values.astype(np.uint32)
    jcol = jlayout.pack(values, width)
    tcol = tlayout.pack(values, width, device="cpu")
    dom = 1 << width
    for keys in (_keys(width, 6, width, (dom, 0xFFFFFFFF)), [int(values[7])] * 3,
                 [dom + 1, 1 << 31], list(range(min(dom, 40)))):
        tbits, tcount = toracle.member_scan(tcol, keys)
        jbits, jcount = joracle.member_scan(jcol, np.asarray(keys, np.uint32))
        np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
        assert int(tcount) == int(jcount) == _expect_count(values, keys)
        wbits, wcount = toracle.member_scan_words(tcol.words, keys, width, N)
        assert torch.equal(wbits, tbits) and int(wcount) == int(tcount)
