"""The port's bit-plane aggregate tiers (on the card one key lookup and
scatter-add a value, for keys in device memory and for host keys; in the
JAX package the XOR plane fold and the static AND-DAG), the block offset
and the aggregate dispatch against the JAX package.

As in test_torch_aggregate.py: the port's plain versions on CPU tensors,
the JAX package's Pallas kernels in interpret mode with its partials
finalized by its own ``finalize_sums``; the same seeded numpy inputs at
b1 = 8 shapes (ragged n, key 0 over the zero padding, duplicate and
out-of-domain keys, 0xFFFFFFFF included); exact agreement.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import aggregate as jagg
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import aggregate as tagg
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

# (predicate width, measure width), as in test_torch_aggregate.py
PAIRS = [(9, 9), (9, 16), (5, 17), (9, 31), (31, 12), (1, 20)]
TOP = 0xFFFFFFFF


def _keys_t(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32).copy())


def _table(wp, wm, seed, n=None):
    """Two columns of one ragged n (B1 = 8 by default), packed by both
    packages."""
    rng = np.random.default_rng(seed)
    n = n or 20_000 + 37 * wp + wm
    p = rng.integers(0, 1 << wp, n, dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 1 << wm, n, dtype=np.uint64).astype(np.uint32)
    jcols = (jlayout.pack_device(p, wp), jlayout.pack_device(m, wm))
    tcols = (tlayout.pack_device(p, wp, device="cpu"), tlayout.pack_device(m, wm, device="cpu"))
    return n, p, m, jcols, tcols


def _keys(wp, p):
    """Key 0 (its padding trap), a duplicated present key, the first key
    out of the domain and 0xFFFFFFFF."""
    return np.asarray([0, p[5], p[5], 1 << wp, TOP], np.uint32)


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
def test_aggregate_bitplane_tiles_matches_jax(wp, wm):
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 20 * wp + wm)
    keys = _keys(wp, p)
    jout = jagg.aggregate_bitplane_tiles(jp.tiles, jm.tiles, jnp.asarray(keys), wp, wm, n,
                                         interpret=True)
    tout = tagg.aggregate_bitplane_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n)
    _assert_sums(tout, *jout, p, m, keys)


@pytest.mark.parametrize("wp,wm", PAIRS)
def test_aggregate_bitplane_static_tiles_matches_jax(wp, wm):
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 30 * wp + wm)
    keys = _keys(wp, p)
    jout = jagg.aggregate_bitplane_static_tiles(jp.tiles, jm.tiles, keys, wp, wm, n,
                                                interpret=True)
    tout = tagg.aggregate_bitplane_static_tiles(tp.tiles, tm.tiles, keys, wp, wm, n)
    _assert_sums(tout, *jout, p, m, keys)


@pytest.mark.parametrize("wm", [1, 20, 31])
@pytest.mark.parametrize("wp", [1, 5, 16, 17, 20, 31])
def test_static_tier_matches_jax_across_widths(wp, wm):
    # the port's key lookup (its plain version) against the JAX AND-DAG
    # tier in interpret mode: the byte table's widths (1, 5, 16) and the
    # search's (17, 20, 31); key 0 over the padding of a ragged n, a
    # duplicate, keys >= 2^wp and 0xFFFFFFFF; a block_offset that drops
    # the last two blocks
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 40 * wp + wm, n=3001 + wp)
    keys = np.asarray([0, p[5], p[5], 1 << wp, TOP, p[7]], np.uint32)
    jout = jagg.aggregate_bitplane_static_tiles(jp.tiles, jm.tiles, keys, wp, wm, n,
                                                interpret=True, block_offset=2)
    tout = tagg.aggregate_bitplane_static_tiles(tp.tiles, tm.tiles, keys, wp, wm, n, 2)
    cut = n - 2 * 32
    _assert_sums(tout, *jout, p[:cut], m[:cut], keys)


@pytest.mark.parametrize("wm", [1, 31])
@pytest.mark.parametrize("wp", [1, 5, 16, 17, 20, 31])
def test_runtime_tier_matches_jax_across_widths(wp, wm):
    # the port's device-key lookup (its plain version: sorted keys,
    # searchsorted, bincount and index_add_) against the JAX runtime
    # bit-plane tier in interpret mode: the byte table's widths (1, 5, 16)
    # and the CTA plan's (17, 20, 31); key 0 over the padding of a ragged
    # n, a duplicate, 2^wp and 0xFFFFFFFF; a block_offset that drops the
    # last two blocks
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 50 * wp + wm, n=3001 + wp)
    keys = np.asarray([0, p[5], p[5], 1 << wp, TOP], np.uint32)
    jout = jagg.aggregate_bitplane_tiles(jp.tiles, jm.tiles, jnp.asarray(keys), wp, wm, n,
                                         interpret=True, block_offset=2)
    tout = tagg.aggregate_bitplane_tiles(tp.tiles, tm.tiles, _keys_t(keys), wp, wm, n, 2)
    cut = n - 2 * 32
    _assert_sums(tout, *jout, p[:cut], m[:cut], keys)


def test_block_offset_matches_jax():
    # a shard whose validity word ends three blocks earlier than its tiles
    wp, wm, off = 7, 20, 3
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 60)
    keys = _keys(wp, p)[:-1]  # 0xFFFFFFFF differs in the JAX compare tier
    jk, tk = jnp.asarray(keys), _keys_t(keys)
    for jf, tf in ((jagg.aggregate_scan_tiles, tagg.aggregate_scan_tiles),
                   (jagg.aggregate_bitplane_tiles, tagg.aggregate_bitplane_tiles)):
        jc, jlo, jhi = jf(jp.tiles, jm.tiles, jk, wp, wm, n, interpret=True, block_offset=off)
        tc, ts = tf(tp.tiles, tm.tiles, tk, wp, wm, n, off)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
        np.testing.assert_array_equal(ts.numpy(), jagg.finalize_sums(jlo, jhi).astype(np.int64))
    # the last three blocks' values (and the padding) drop out
    cut = n - 3 * 32
    sums, counts = _truth(p[:cut], m[:cut], keys)
    tc, ts = tagg.aggregate_bitplane_static_tiles(tp.tiles, tm.tiles, keys, wp, wm, n, off)
    np.testing.assert_array_equal(ts.numpy(), sums)
    np.testing.assert_array_equal(tc.numpy(), counts)
    tc, tmn, tmx = tagg.minmax_scan_tiles(tp.tiles, tm.tiles, tk, wp, wm, n, off)
    np.testing.assert_array_equal(tc.numpy(), counts)


def test_aggregate_scan_device_matches_jax_on_both_tiers():
    wp, wm = 9, 16
    n, p, m, (jp, jm), (tp, tm) = _table(wp, wm, 70)
    before = {f: profiling.launch_count(f) for f in (tagg.aggregate_scan_tiles,
                                      tagg.aggregate_bitplane_static_tiles)}
    for k, tier in ((2, "compare"), (24, "bitplane")):
        keys = np.random.default_rng(k).permutation(1 << wp)[:k].astype(np.uint32)
        assert tagg.pick_aggregate_tier(wp, wm, keys) == tier
        jsums, jcounts = jagg.aggregate_scan_device(jp, jm, keys, interpret=True)
        tsums, tcounts = tagg.aggregate_scan_device(tp, tm, keys)
        np.testing.assert_array_equal(tsums.numpy(), jsums.astype(np.int64))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))
    # CPU tensors take the plain versions: nothing launches
    assert all(profiling.launch_count(f) == c for f, c in before.items())
