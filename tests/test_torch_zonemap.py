"""The port's zone maps against the JAX package and numpy.

The same columns (from a numpy seed) go to both packages, the JAX one in
interpret mode, as its own tests run it (``tests/test_zonemap.py``).  Zone
maps, spans, step masks, dispatch decisions, bitvector words and counts
must be equal (tolerance 0), and a zone map built by the JAX package
serves the port as it is.  The CUDA kernel is held against the plain
version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu import zonemap as jzm
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import query as tq
from shared_simd_scan_tpu_torch import zonemap as tzm
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _column(values, width=9):
    jdev = jlayout.pack_device(jnp.asarray(values), width)
    return jdev, tlayout.from_jax_numpy(width, values.size, np.asarray(jdev.tiles), "cpu")


def _sorted(n, seed):
    return np.sort(np.random.default_rng(seed).integers(0, 512, size=n, dtype=np.uint32))


def _ends(n, seed, key=7):
    """Values in 100..199, ``key`` in the first and last 8 block rows."""
    vals = np.random.default_rng(seed).integers(100, 200, size=n, dtype=np.uint32)
    vals[: 4096 * 8] = key
    vals[-4096 * 8:] = key
    return vals


def _same_scan(tout, jout, values, lo, hi):
    tbits, tcount = tout
    jbits, jcount = jout
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    mask = (values >= lo) & (values < hi)
    assert int(tcount) == int(jcount) == int(mask.sum()), (lo, hi)
    np.testing.assert_array_equal(tbitvector.to_bool(tbits, values.size).numpy(), mask)


@pytest.mark.parametrize("n", [40_000, 70_003])  # exact and ragged last zone
def test_build_zonemap_matches_jax(n):
    values = np.random.default_rng(n).integers(1, 512, size=n, dtype=np.uint32)
    values[5000:9000] = np.sort(values[5000:9000])
    jdev, tdev = _column(values)
    jmap = jzm.build_zonemap(jdev, zone_b1=8, interpret=True)
    tmap = tzm.build_zonemap(tdev, zone_b1=8, chunk_zones=2)  # several chunks
    vmap = tzm.build_zonemap_from_values(values, tdev.tiles.shape[1], zone_b1=8)
    for m in (tmap, vmap):
        assert (m.zone_b1, m.b1, m.nzones) == (jmap.zone_b1, jmap.b1, jmap.nzones)
        assert m.zmin.dtype == m.zmax.dtype == np.uint32
        np.testing.assert_array_equal(m.zmin, jmap.zmin)
        np.testing.assert_array_equal(m.zmax, jmap.zmax)
    # all-padding zones report (0xFFFFFFFF, 0)
    tiny = tlayout.pack_device(np.full(200, 37, np.uint32), 9, device="cpu")
    zmap = tzm.build_zonemap(tiny, zone_b1=8)
    assert zmap.zmin.tolist() == [37] + [0xFFFFFFFF] * (zmap.nzones - 1)
    assert zmap.zmax.tolist() == [37] + [0] * (zmap.nzones - 1)


def test_spans_and_step_masks_match_jax():
    values = np.concatenate([_sorted(70_000, 1), _ends(9 * 8 * 128 * 32, 5)])
    jdev, tdev = _column(values)
    jmap = jzm.build_zonemap(jdev, zone_b1=8, interpret=True)
    queries = [(0, 1), (17, 18), (100, 102), (100, 120), (7, 8), (0, 512), (511, 512),
               (300, 400), (600, 700), (150, 160)]
    for lo, hi in queries:
        # the JAX package's ZoneMap serves the port's functions as it is
        assert tzm.prune_span(jmap, lo, hi) == jzm.prune_span(jmap, lo, hi)
        for tb in (8, 16, 48):
            np.testing.assert_array_equal(tzm.zone_step_mask(jmap, lo, hi, tb),
                                          jzm.zone_step_mask(jmap, lo, hi, tb))
    for b1, tb in ((72, None), (72, 256), (72, 20), (24, 128), (116736, 256)):
        assert tzm._pick_tb(b1, tb) == jzm._pick_tb(b1, tb)
    with pytest.raises(ValueError, match="must divide") as terr:
        tzm.zone_step_mask(jmap, 0, 1, 7)
    with pytest.raises(ValueError) as jerr:
        jzm.zone_step_mask(jmap, 0, 1, 7)
    assert str(terr.value) == str(jerr.value)
    for build in (lambda: tzm.build_zonemap(tdev, zone_b1=7),
                  lambda: tzm.build_zonemap_from_values(values, tdev.tiles.shape[1], zone_b1=12)):
        with pytest.raises(ValueError, match="zone_b1"):
            build()


class _Calls:
    """Records which path a pruned or zoned scan took, calling through."""

    def __init__(self, monkeypatch):
        self.log = []
        real_range, real_zoned = tzm.range_scan_tiles, tzm.zoned_range_tiles

        def range_scan(*args, rows=None):
            self.log.append("full" if rows is None else ("span",) + tuple(rows))
            return real_range(*args, rows=rows)

        def zoned(tiles, idx, flag, *args):
            self.log.append(("zoned", tuple(idx.tolist()), tuple(flag.tolist())))
            return real_zoned(tiles, idx, flag, *args)

        monkeypatch.setattr(tzm, "range_scan_tiles", range_scan)
        monkeypatch.setattr(tzm, "zoned_range_tiles", zoned)

    def take(self):
        out, self.log = self.log, []
        return out


def test_pruned_scans_match_jax(monkeypatch):
    values = _sorted(70_000, 1)
    jdev, tdev = _column(values)
    zmap = jzm.build_zonemap(jdev, zone_b1=8, interpret=True)
    calls = _Calls(monkeypatch)
    # (lo, hi, the path): point queries, a range over zone edges, the whole
    # domain (the full-column fallback), nothing
    cases = [(17, 18, ("span", 0, 8)), (100, 120, ("span", 0, 8)), (511, 512, ("span", 16, 8)),
             (0, 512, "full"), (600, 700, None)]
    for lo, hi, path in cases:
        tout = tzm.pruned_range_scan(tdev, zmap, lo, hi)
        _same_scan(tout, jzm.pruned_range_scan(jdev, zmap, lo, hi, interpret=True), values, lo, hi)
        assert calls.take() == ([] if path is None else [path]), (lo, hi)
    bits, count = tzm.pruned_eq_scan(tdev, zmap, 17, full_bits=False)
    assert bits is None and int(count) == int((values == 17).sum())


def test_zoned_scans_match_jax(monkeypatch):
    values = _ends(9 * 8 * 128 * 32, 5)
    jdev, tdev = _column(values)
    zmap = jzm.build_zonemap(jdev, zone_b1=8, interpret=True)
    calls = _Calls(monkeypatch)
    cases = [(7, 8, ("zoned", (0, 8), (1, 1))), (150, 160, "full"), (300, 400, None)]
    for lo, hi, path in cases:
        tout = tzm.zoned_range_scan(tdev, zmap, lo, hi, tb=8)
        _same_scan(tout, jzm.zoned_range_scan(jdev, zmap, lo, hi, tb=8, interpret=True),
                   values, lo, hi)
        assert calls.take() == ([] if path is None else [path]), (lo, hi)
    _same_scan(tzm.zoned_eq_scan(tdev, zmap, 7, tb=8),
               jzm.zoned_eq_scan(jdev, zmap, 7, tb=8, interpret=True), values, 7, 8)


def test_padded_step_list_matches_jax():
    # three live steps padded to g = 4 as the JAX package pads them: the
    # flag-0 step revisits a live step and must not count twice
    n = 9 * 8 * 128 * 32 - 77  # ragged: the validity tail inside the last step
    values = np.random.default_rng(7).integers(100, 200, size=n, dtype=np.uint32)
    for z in (0, 16, 64):
        values[z * 4096 : (z + 8) * 4096] = 9
    jdev, tdev = _column(values)
    zmap = jzm.build_zonemap(jdev, zone_b1=8, interpret=True)
    live = tzm.zone_step_mask(zmap, 9, 10, 8)
    assert np.nonzero(live)[0].tolist() == [0, 2, 8]
    idx = np.array([0, 2, 8, 8], np.int32)
    flag = np.array([1, 1, 1, 0], np.int32)
    lows, highs = np.array([9, 150], np.uint32), np.array([10, 152], np.uint32)
    jbits, jcounts = jzm._zoned_range_tiles(
        jdev.tiles, jnp.asarray(idx), jnp.asarray(flag), jnp.asarray(lows), jnp.asarray(highs),
        g=4, width=9, n=n, tb=8, interpret=True)
    tbits, tcounts = tzm.zoned_range_tiles(
        tdev.tiles, torch.from_numpy(idx), torch.from_numpy(flag),
        torch.from_numpy(lows.view(np.int32)), torch.from_numpy(highs.view(np.int32)), 9, n, 8)
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    in_steps = np.zeros(n, bool)
    for s in (0, 2, 8):
        in_steps[s * 8 * 4096 : (s + 1) * 8 * 4096] = True
    assert tcounts.tolist() == [int(((values == 9) & in_steps).sum()),
                                int(((values >= 150) & (values < 152) & in_steps).sum())]


def test_evaluate_with_jax_zone_maps_matches_jax():
    # the JAX test's expressions; the JAX-built ZoneMap goes to the port as it is
    width, n = 9, 40_000
    rng = np.random.default_rng(7)
    a_vals = np.sort(rng.integers(0, 1 << width, size=n, dtype=np.uint32))
    b_vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    (ja, ta), (jb, tb) = _column(a_vals), _column(b_vals)
    zmap = jzm.build_zonemap(ja, zone_b1=8, interpret=True)
    jmaps, tmaps = {id(ja): zmap}, {id(ta): zmap}
    trees = [
        (lambda q, a, b: q.And(q.Range(a, 100, 120), q.Not(q.Eq(b, 7))),
         (a_vals >= 100) & (a_vals < 120) & (b_vals != 7)),
        (lambda q, a, b: q.Or(q.Eq(a, 3), q.Range(b, 500, 512)),
         (a_vals == 3) | (b_vals >= 500)),
        (lambda q, a, b: q.And(q.Range(a, 50, 400), q.Range(a, 60, 70), q.Range(b, 0, 300)),
         (a_vals >= 60) & (a_vals < 70) & (b_vals < 300)),
    ]
    for build, mask in trees:
        jbits, jcount = jq.evaluate(build(jq, ja, jb), interpret=True, zonemaps=jmaps)
        tbits, tcount = tq.evaluate(build(tq, ta, tb), zonemaps=tmaps)
        np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
        assert int(tcount) == int(jcount) == int(mask.sum())
        plain_bits, plain_count = tq.evaluate(build(tq, ta, tb))
        assert torch.equal(tbits, plain_bits) and int(plain_count) == int(tcount)


def test_eq_scan_at_the_top_of_uint32_is_a_standing_difference(monkeypatch):
    # key 0xFFFFFFFF: the JAX package builds hi = 2^32 as a uint32 array and
    # raises; the port prunes first, finds no zone that can hold the key and
    # returns a zero row and count 0 without a launch.  A range ending at
    # 2^32 that reaches a zone is read as [lo, 2^32).
    values = _sorted(70_000, 1)
    jdev, tdev = _column(values)
    zmap = jzm.build_zonemap(jdev, zone_b1=8, interpret=True)
    for jscan_fn in (jzm.pruned_eq_scan, jzm.zoned_eq_scan):
        with pytest.raises(OverflowError):
            jscan_fn(jdev, zmap, 0xFFFFFFFF, interpret=True)

    def no_launch(*args, **kwargs):
        raise AssertionError("a kernel ran for key 0xFFFFFFFF")

    monkeypatch.setattr(tzm, "range_scan_tiles", no_launch)
    monkeypatch.setattr(tzm, "zoned_range_tiles", no_launch)
    for tscan_fn in (tzm.pruned_eq_scan, tzm.zoned_eq_scan):
        bits, count = tscan_fn(tdev, zmap, 0xFFFFFFFF)
        assert int(count) == 0 and bits.shape == (tlayout.bitvector_words(values.size),)
        assert not bits.any()
    monkeypatch.undo()
    calls = _Calls(monkeypatch)
    mask = values >= 500
    for scan_fn, path in ((tzm.pruned_range_scan, ("span", 16, 8)),
                          (lambda *a: tzm.zoned_range_scan(*a, tb=8), ("zoned", (2,), (1,)))):
        bits, count = scan_fn(tdev, zmap, 500, 1 << 32)
        assert calls.take() == [path]
        assert int(count) == int(mask.sum()) > 0
        np.testing.assert_array_equal(tbitvector.to_bool(bits, values.size).numpy(), mask)


def _zone_map(cls, zone_b1, b1, nz=None):
    """Zone z holds [10 z, 10 z + 9]; the last two zones are all padding."""
    nz = b1 // zone_b1 if nz is None else nz
    zmin = (np.arange(nz) * 10).astype(np.uint32)
    zmax = zmin + 9
    zmin[-2:], zmax[-2:] = 0xFFFFFFFF, 0
    return cls(zone_b1=zone_b1, b1=b1, zmin=zmin, zmax=zmax)


@pytest.mark.parametrize("zone_b1", [8, 64])
@pytest.mark.parametrize("tb", [8, 16, 72, 256])
def test_zone_step_mask_matches_jax(tb, zone_b1):
    # b1 = 2304 takes every tb and zone_b1 here: steps cover part of a zone,
    # a zone, or several, and straddle zone edges at tb = 72
    b1 = 2304
    nz = b1 // zone_b1
    last = 10 * (nz - 3)  # the last zone that holds values
    ranges = [(0, 1), (last + 9, last + 10), (10 * nz, 10 * nz + 5), (0, 1 << 32), (55, 310),
              (7, 8), (last, 1 << 32), (5, 6)]
    for tmap, jmap in ((_zone_map(tzm.ZoneMap, zone_b1, b1), _zone_map(jzm.ZoneMap, zone_b1, b1)),
                       # fewer zones than b1 holds: both clip to the zones there are
                       (_zone_map(tzm.ZoneMap, zone_b1, b1, nz - 5),
                        _zone_map(jzm.ZoneMap, zone_b1, b1, nz - 5))):
        for lo, hi in ranges:
            got = tzm.zone_step_mask(tmap, lo, hi, tb)
            want = jzm.zone_step_mask(jmap, lo, hi, tb)
            assert got.dtype == want.dtype == np.bool_
            np.testing.assert_array_equal(got, want)
        assert tzm.zone_step_mask(tmap, 0, 1, tb)[0]
        assert not tzm.zone_step_mask(tmap, 10 * nz, 10 * nz + 5, tb).any()
        assert tzm.zone_step_mask(tmap, 0, 1 << 32, tb)[: (nz - 5) * zone_b1 // tb].all()


def test_zoned_count_form_matches_jax():
    values = _ends(9 * 8 * 128 * 32, 5)
    jdev, tdev = _column(values)
    zmap = jzm.build_zonemap(jdev, zone_b1=8, interpret=True)
    for lo, hi in ((7, 8), (150, 160), (300, 400), (100, 108)):
        tbits, tcount = tzm.zoned_range_scan(tdev, zmap, lo, hi, tb=8, full_bits=False)
        jbits, jcount = jzm.zoned_range_scan(jdev, zmap, lo, hi, tb=8, interpret=True,
                                             full_bits=False)
        assert tbits is None and jbits is None
        assert int(tcount) == int(jcount) == int(((values >= lo) & (values < hi)).sum()), (lo, hi)


def test_zoned_wrapper_launch_arguments(monkeypatch):
    # the CUDA branch with the launch recorded: one launch a call, the row
    # from torch.empty (the C entry writes every word; no torch.zeros), the
    # count form with no bits pointer
    calls = []
    monkeypatch.setattr(tzm._cuda, "kernel_device", lambda *ts: torch.device("cpu"))
    monkeypatch.setattr(tzm._cuda, "launch", lambda fn, device, *args: calls.append((fn, args)))
    b1, tb, width, n = 72, 8, 9, 9 * 8 * 128 * 32 - 77
    tiles = torch.zeros((width, b1, 128), dtype=torch.int32)
    idx = torch.tensor([8, 0, 4, 4], dtype=torch.int32)
    flag = torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    lows = torch.tensor([7, 100], dtype=torch.int32)
    highs = torch.tensor([8, 120], dtype=torch.int32)

    def no_zeros(*args, **kwargs):
        raise AssertionError("torch.zeros on the kernel's path")

    for full_bits in (True, False):
        calls.clear()
        before = profiling.launch_count(tzm.zoned_range_tiles)
        with monkeypatch.context() as m:
            m.setattr(torch, "zeros", no_zeros)
            bits, counts = tzm.zoned_range_tiles(tiles, idx, flag, lows, highs, width, n, tb,
                                                 full_bits)
        assert profiling.launch_count(tzm.zoned_range_tiles) == before + 1
        assert counts.shape == (2,) and counts.dtype == torch.int64
        ((fn, args),) = calls
        assert fn == "sss_zoned_range_scan"
        want = (tiles.data_ptr(), idx.data_ptr(), flag.data_ptr(), 4, lows.data_ptr(),
                highs.data_ptr(), 2, bits.data_ptr() if full_bits else None, counts.data_ptr(),
                b1 * 128, tb * 128, width, n)
        assert args == want
        assert (bits is None) == (not full_bits)
        if full_bits:
            assert bits.shape == (2, b1, 128) and bits.dtype == torch.int32
    # zoned_range_scan takes the count form when it needs no bits
    values = _ends(n, 5)
    zmap = tzm.build_zonemap_from_values(values, b1, zone_b1=8)
    tdev = tlayout.pack_device(values, width, device="cpu")
    for full_bits in (True, False):
        calls.clear()
        tzm.zoned_range_scan(tdev, zmap, 7, 8, tb=tb, full_bits=full_bits)
        ((fn, args),) = calls
        assert fn == "sss_zoned_range_scan" and (args[3], args[6]) == (3, 1)  # steps 0, 7, 8; k 1
        assert (args[7] is None) == (not full_bits)
