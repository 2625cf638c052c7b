"""The port's range scan and fused multi-column conjunction against the JAX
package.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same columns from a numpy seed and must agree bit for bit (words
and counts, tolerance 0).  The CUDA kernels are held against the plain
versions in test_torch_cuda.py.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import conj as jconj
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import conj as tconj
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
    np.testing.assert_array_equal(np.asarray(tout[1].numpy(), np.int64),
                                  np.asarray(jout[1]).astype(np.int64))


# ---------------------------------------------------------------------------
# range scan
# ---------------------------------------------------------------------------

RANGE_CASES = [
    # width, lows, highs, block_offset
    (1, [0, 1, 1], [1, 2, 0], 0),                     # [1, 0): a wrapped span
    (9, [100, 300, 7, 0], [400, 2, 7, 512], 0),       # wrapped, empty, full
    (17, [0, 5000, 70000], [65536, 131072, 3], 300),  # a shard holding the column's end
    (31, [0, 1 << 30, 5], [1 << 31, (1 << 31) + 5, 4], 0),
]


@pytest.mark.parametrize("width,lows,highs,offset", RANGE_CASES)
def test_range_scan_tiles_matches_jax(width, lows, highs, offset):
    values, jdev, tdev = _column(width, N, seed=width)
    jout = jscan.range_scan_tiles(jdev.tiles, jnp.asarray(lows, jnp.uint32),
                                  jnp.asarray(highs, jnp.uint32), width, N, interpret=True,
                                  block_offset=offset)
    tout = tscan.range_scan_tiles(tdev.tiles, _t32(lows), _t32(highs), width, N, offset)
    _assert_same(tout, jout)
    if offset == 0:
        span = (np.asarray(highs, np.int64) - lows) % (1 << 32)
        inside = ((values.astype(np.int64)[None] - np.asarray(lows)[:, None]) % (1 << 32)
                  < span[:, None])
        assert tout[1].tolist() == inside.sum(axis=1).tolist()


def test_range_scan_device_matches_jax_and_takes_hi_2_32():
    width = 9
    values, jdev, tdev = _column(width, N, seed=2)
    lows, highs = [3, 200], [90, 100]
    jbits, jcounts = jscan.range_scan_device(jdev, lows, highs, interpret=True)
    tbits, tcounts = tscan.range_scan_device(tdev, lows, highs)
    _assert_same((tbits, tcounts), (jbits, jcounts))
    # hi = 2^32 is the range [lo, 2^32): it wraps to 0 and spans 2^32 - lo
    bits, counts = tscan.range_scan_device(tdev, [500, 0xFFFFFFFE], [1 << 32, 1 << 32])
    assert counts.tolist() == [int(np.sum(values >= 500)), 0]
    with pytest.raises(ValueError):
        tscan.range_scan_device(tdev, [0], [(1 << 32) + 1])


def test_range_scan_refuses_bad_bounds():
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tscan.range_scan_tiles(tiles, _t32([1, 2]), _t32([3]), 9, 100)
    with pytest.raises(TypeError):
        tscan.range_scan_tiles(tiles, torch.zeros(1, dtype=torch.int64),
                               torch.zeros(1, dtype=torch.int64), 9, 100)


# ---------------------------------------------------------------------------
# conjunction
# ---------------------------------------------------------------------------

CONJ_CASES = [
    # widths, lows, highs, block_offset
    ((9,), [100], [400], 0),
    ((1, 17, 31), [1, 5000, 3], [2, 90000, 1 << 30], 0),
    ((2, 16, 9), [1, 100, 50], [4, 100, 450], 0),                 # hi == lo: empty
    ((5, 9, 4), [2, 400, 1], [30, 100, 16], 0),                   # hi < lo: empty, not wrapped
    ((1, 2, 5, 9, 12, 16, 17, 31), [0, 1, 3, 10, 100, 1000, 0, 0],
     [2, 4, 30, 500, 4000, 60000, 100000, 1 << 31], 200),          # 8 columns, a shard
]


@pytest.mark.parametrize("widths,lows,highs,offset", CONJ_CASES)
def test_conj_range_scan_tiles_matches_jax(widths, lows, highs, offset):
    cols = [_column(w, N, seed=10 + i) for i, w in enumerate(widths)]
    jout = jconj.conj_range_scan_tiles(tuple(c[1].tiles for c in cols),
                                       jnp.asarray(lows, jnp.uint32),
                                       jnp.asarray(highs, jnp.uint32), widths, N,
                                       interpret=True, block_offset=offset)
    tout = tconj.conj_range_scan_tiles(tuple(c[2].tiles for c in cols), lows, highs, widths, N,
                                       offset)
    _assert_same(tout, jout)
    if offset == 0:
        expect = np.ones(N, bool)
        for (values, _, _), lo, hi in zip(cols, lows, highs):
            expect &= (values >= lo) & (values < hi)
        assert int(tout[1]) == int(expect.sum())


def test_conj_device_and_eq_match_jax():
    cols = [_column(w, N, seed=20 + w) for w in (9, 5)]
    keys = [int(cols[0][0][7]), int(cols[1][0][7])]
    jbits, jcount = jconj.conj_eq_scan_device([c[1] for c in cols], keys, interpret=True)
    tbits, tcount = tconj.conj_eq_scan_device([c[2] for c in cols], keys)
    _assert_same((tbits, tcount), (jbits, jcount))
    assert int(tcount) >= 1
    # key 0xFFFFFFFF: key + 1 wraps to 0, an empty range, as in the JAX package
    _, count = tconj.conj_eq_scan_device([cols[0][2]], [0xFFFFFFFF])
    assert int(count) == 0


def test_conj_refuses_what_the_kernel_cannot_take():
    tiles9 = torch.zeros((9, 8, 128), dtype=torch.int32)
    tiles5 = torch.zeros((5, 16, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="1..8 columns"):
        tconj.conj_range_scan_tiles((tiles9,) * 9, [0] * 9, [1] * 9, (9,) * 9, 100)
    with pytest.raises(ValueError, match="share n"):
        tconj.conj_range_scan_tiles((tiles9, tiles5), [0, 0], [1, 1], (9, 5), 100)
    with pytest.raises(ValueError, match="uint32"):
        tconj.conj_range_scan_tiles((tiles9,), [0], [1 << 32], (9,), 100)
    with pytest.raises(ValueError):
        tconj.conj_range_scan_tiles((tiles9,), [0, 1], [1, 2], (9,), 100)
    a = tlayout.pack_device(np.zeros(100, np.uint32), 9, device="cpu")
    b = tlayout.pack_device(np.zeros(200, np.uint32), 9, device="cpu")
    with pytest.raises(ValueError, match="share n"):
        tconj.conj_range_scan_device([a, b], [0, 0], [1, 1])


# The kernel's compare (csrc/conj.cu), modelled in numpy: the value at the
# top of a word above bits of the values before it, the bounds clamped to
# 2^W and shifted up the same way, and the carry of (lo - 1 - x) + span; a
# range that holds every W-bit value is not compared.  It must give the
# wrappers' semantics, (v - lo) mod 2^32 < span with span 0 for hi <= lo.
COMPARE_WIDTHS = [1, 2, 4, 6, 9, 12, 16, 17, 24, 31]


def _kernel_compare(values, width, lo, hi, below):
    dom, k = 1 << width, 32 - width
    lo_c, hi_c = min(lo, dom), min(hi, dom)
    if lo_c == 0 and hi_c == dom:
        return np.ones(values.shape, bool)
    lo_t, span_t = (lo_c << k, (hi_c - lo_c) << k) if hi_c > lo_c else (0, 0)
    x = (values.astype(np.uint64) << np.uint64(k)) | (below & np.uint64((1 << k) - 1))
    a = (np.uint64(lo_t + 0xFFFFFFFF) - x) & np.uint64(0xFFFFFFFF)  # lo - 1 - x mod 2^32
    return (a + np.uint64(span_t)) >> np.uint64(32) == 1


@pytest.mark.parametrize("width", COMPARE_WIDTHS)
def test_kernel_compare_gives_the_range_semantics(width):
    rng = np.random.default_rng(width)
    dom = 1 << width
    if width <= 12:
        values = np.arange(dom, dtype=np.uint64)
    else:
        values = np.concatenate([rng.integers(0, dom, 4000, dtype=np.uint64),
                                 np.array([0, 1, dom - 2, dom - 1], np.uint64)])
    below = rng.integers(0, 1 << 32, values.shape, dtype=np.uint64)
    edges = [0, 1, dom // 3, dom - 1, dom, dom + 5, 0xFFFFFFFF]
    bounds = [(lo, hi) for lo in edges for hi in edges]
    bounds += [tuple(int(b) for b in rng.integers(0, dom, 2)) for _ in range(40)]
    for lo, hi in bounds:
        span = hi - lo if hi > lo else 0
        want = ((values - np.uint64(lo)) & np.uint64(0xFFFFFFFF)) < np.uint64(span)
        got = _kernel_compare(values, width, lo, hi, below)
        np.testing.assert_array_equal(got, want, err_msg=f"width {width}, [{lo}, {hi})")


def test_launch_reads_a_span_in_place_and_counts_one_launch(monkeypatch):
    """The wrapper's launch arguments, with the launch recorded instead of
    made: a whole column from its first block, a span from its first block
    row with the columns' full row length as the stride and the bits row
    zeroed around it; one launch counted either way."""
    calls = []

    def launch(fn, device, *args):  # the column pointers read while their array lives
        calls.append((list(np.frombuffer(ctypes.string_at(args[0], 3 * 8), np.int64)), args))

    monkeypatch.setattr(tconj._cuda, "kernel_device", lambda *ts: torch.device("cpu"))
    monkeypatch.setattr(tconj._cuda, "launch", launch)
    cols = [_column(w, N, seed=30 + w)[2] for w in (12, 6, 4)]
    tiles = tuple(c.tiles for c in cols)
    b1 = tiles[0].shape[1]

    def run(rows=None):
        before = profiling.counters().get("launches.conj_range_scan_tiles", 0)
        bits, _ = tconj.conj_range_scan_tiles(tiles, [1, 2, 3], [900, 40, 9], (12, 6, 4), N,
                                              rows=rows)
        assert profiling.counters()["launches.conj_range_scan_tiles"] == before + 1
        return bits, calls[-1]

    _, (ptrs, args) = run()
    assert ptrs == [t.data_ptr() for t in tiles] and args[4] == 3
    assert args[7:11] == (b1 * tlayout.LANES, b1 * tlayout.LANES, N, 0)
    bits, (ptrs, args) = run(rows=(1, 1))
    assert ptrs == [t.data_ptr() + tlayout.LANES * 4 for t in tiles]
    assert args[5] == bits.data_ptr() + tlayout.LANES * 4 and not bits.any()
    assert args[7:11] == (tlayout.LANES, b1 * tlayout.LANES, N, tlayout.LANES)


def test_cpu_wrappers_launch_nothing():
    _, _, tdev = _column(9, 1000, seed=1)
    fns = (tscan.range_scan_tiles, tconj.conj_range_scan_tiles)
    before = [profiling.launch_count(f) for f in fns]
    tscan.range_scan_tiles(tdev.tiles, _t32([1]), _t32([5]), 9, 1000)
    tconj.conj_range_scan_tiles((tdev.tiles,), [1], [5], (9,), 1000)
    assert [profiling.launch_count(f) for f in fns] == before
