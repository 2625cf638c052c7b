"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit, is marked ``cuda``
and skips without a card.  The file imports no JAX, so it runs on a machine
without it; the repository's conftest imports JAX, so there run it as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The plain versions are held against the JAX package on the CPU in the other
test_torch_*.py files.  Integer results, tolerance 0.
"""
import numpy as np
import pytest
import torch

import shared_simd_scan_tpu_torch as port
from shared_simd_scan_tpu_torch import bitvector, query
from shared_simd_scan_tpu_torch.bench import harness
from shared_simd_scan_tpu_torch.ops import _cuda, aggregate, conj, linear, member, oracle, scan, unpack
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

WIDTHS = [1, 2, 9, 16, 17, 31]
N = 33 * 128 + 17


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _values(width, n, seed, device):
    v = np.random.default_rng(seed).integers(0, 1 << width, size=n).astype(np.uint32)
    return torch.from_numpy(v.view(np.int32)).to(device)


def _keys(keys, device):
    return torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32).copy()).to(device)


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_unpack_kernels_match_plain(cuda_device, width):
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 1 << 32, size=(32, 8, 128), dtype=np.uint64).astype(np.uint32)
    raw = torch.from_numpy(raw.view(np.int32)).to(cuda_device)
    tiles = unpack.pack_tiles(raw, width)
    _same(tiles, unpack.pack_tiles_plain(raw, width))
    vals = unpack.unpack_tiles(tiles, width)
    _same(vals, unpack.unpack_tiles_plain(tiles, width))
    _same(vals, raw & ((1 << width) - 1))


@pytest.mark.parametrize("width", WIDTHS)
def test_scan_kernels_match_plain(cuda_device, width):
    values = _values(width, N, width, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    for keys in ([0], [dom, 1 << 31, 0xFFFFFFFF], [int(values[2]), int(values[4]), 0]):
        kt = _keys(keys, cuda_device)
        _same(scan.shared_scan_tiles(tiles, kt, width, N),
              scan.shared_scan_tiles_plain(tiles, kt, width, N))
    for lo, k in ((0, 8), (max(dom - 4, 0), 8), (0, 20), (0, 33), (0, 100), (0, 1024)):
        _same(scan.interval_scan_tiles(tiles, lo, k, width, N),
              scan.interval_scan_tiles_plain(tiles, lo, k, width, N))


def test_block_offset_matches_plain(cuda_device):
    width, n = 9, 30_000
    tiles = unpack.pack_device_kernel(_values(width, n, 3, cuda_device), width).tiles
    offset = 8 * 128 * 3 - 200
    kt = _keys([0, 5], cuda_device)
    _same(scan.shared_scan_tiles(tiles, kt, width, n, block_offset=offset),
          scan.shared_scan_tiles_plain(tiles, kt, width, n, block_offset=offset))
    _same(scan.interval_scan_tiles(tiles, 0, 8, width, n, block_offset=offset),
          scan.interval_scan_tiles_plain(tiles, 0, 8, width, n, block_offset=offset))


def test_compare_kernel_past_1024_keys(cuda_device):
    # the wrapper launches keys in chunks of 1024, each counted under the
    # kernel pick_route names: the compare kernel, the fold or the dynamic
    # scan's lookup
    width = 11
    tiles = unpack.pack_device_kernel(_values(width, N, 11, cuda_device), width).tiles
    kt = _keys((np.arange(1500) * 7) % 2048, cuda_device)
    fns = (scan.shared_scan_tiles, scan.shared_scan_bitsliced_tiles,
           scan.shared_scan_dynamic_tiles)
    before = [profiling.launch_count(fn) for fn in fns]
    _same(scan.shared_scan_tiles(tiles, kt, width, N),
          scan.shared_scan_tiles_plain(tiles, kt, width, N))
    assert [profiling.launch_count(fn) - b for fn, b in zip(fns, before)] == \
        _compare_launches(width, 1500)


def _compare_launches(width, k):
    """Launches of shared_scan_tiles on k keys, by wrapper: the compare
    kernel, the fold, the dynamic scan."""
    out = [0, 0, 0]
    for g0 in range(0, k, scan.MAX_LAUNCH_KEYS):
        out[("compare", "fold", "lookup").index(
            scan.pick_route(width, min(k - g0, scan.MAX_LAUNCH_KEYS)))] += 1
    return out


# ragged n: one tile of 256 blocks, and two and a half (a last tile of 128)
SCAN_NS = (N, 5 * 128 * 32 - 7)
INTERVAL_KS = (1, 7, 8, 9, 31, 32, 33, 1024)


def _interval_launch(tiles, lo, k, width, n, bo, gateless):
    """sss_interval_scan with the one-hot form chosen here, not by the canary."""
    b1 = tiles.shape[1]
    bits = torch.empty((k, b1, 128), dtype=torch.int32, device=tiles.device)
    counts = torch.zeros(k, dtype=torch.int64, device=tiles.device)
    _cuda.launch("sss_interval_scan", tiles.device, tiles.data_ptr(), lo, k, bits.data_ptr(),
                 counts.data_ptr(), b1 * 128, width, n, bo, int(gateless))
    return bits, counts


@pytest.mark.parametrize("width", range(1, 32))
def test_interval_kernel_every_width_matches_plain(cuda_device, width):
    # k around a round of 8 and a chunk of 32, lo 0, near the top of the
    # domain and wrapping past 2^32 - 1, gateless and gated, ragged n and a
    # block_offset; the wrapper (the canary's form) too
    dom = 1 << width
    for n in SCAN_NS:
        tiles = unpack.pack_device_kernel(_values(width, n, width + 300, cuda_device), width).tiles
        for k in INTERVAL_KS:
            for lo in (0, max(dom - 4, 0), (1 << 32) - 3):
                for bo in (0, 3):
                    want = scan.interval_scan_tiles_plain(tiles, lo, k, width, n, bo)
                    for gateless in (True, False):
                        _same(_interval_launch(tiles, lo, k, width, n, bo, gateless), want)
                    if k in (8, 33):
                        _same(scan.interval_scan_tiles(tiles, lo, k, width, n, bo), want)


@pytest.mark.parametrize("width", range(1, 32))
def test_interval_linear_kernel_every_width_matches_plain(cuda_device, width):
    # row 6 shares the interval kernel's body
    dom = 1 << width
    tiles = unpack.pack_device_kernel(_values(width, N, width + 400, cuda_device), width).tiles
    for k in (4, 8, 12, 32, 36, 64, 128):
        for lo in (0, max(dom - 5, 0), (1 << 32) - 3):
            for bo in (0, 2):
                _same(scan._interval_linear_tiles_impl(tiles, lo, k, width, N, bo),
                      scan._interval_linear_tiles_plain(tiles, lo, k, width, N, bo))


COMPARE_KS = (1, 2, 3, 4, 5, 8, 32, 33, 64, 1024, 1025)


def _compare_edge_keys(k, width, values, rng):
    """k keys drawn from the column with key 0 (over the padding of a
    ragged n), a duplicate, 2^width, 2^31 and 0xFFFFFFFF among them."""
    keys = values[rng.integers(0, values.shape[0], size=k)].astype(np.uint64)
    for at, key in ((0, 0), (1, int(keys[0])), (2, 1 << width), (3, 1 << 31), (4, 0xFFFFFFFF)):
        if at < k:
            keys[at] = key
    return keys


def _compare_launch(tiles, kt, width, n, bo):
    """sss_shared_scan itself, whatever the rule says."""
    k, b1 = kt.shape[0], tiles.shape[1]
    bits = torch.empty((k, b1, 128), dtype=torch.int32, device=tiles.device)
    counts = torch.zeros(k, dtype=torch.int64, device=tiles.device)
    _cuda.launch("sss_shared_scan", tiles.device, tiles.data_ptr(), kt.data_ptr(), k,
                 bits.data_ptr(), counts.data_ptr(), b1 * 128, width, n, bo)
    return bits, counts


@pytest.mark.parametrize("width", range(1, 32))
def test_compare_wrapper_every_width_both_sides_of_the_rule(cuda_device, width):
    # the wrapper (the kernel pick_route names), the compare kernel itself
    # and the fold itself, each against the plain compare
    rng = np.random.default_rng(width + 500)
    fns = (scan.shared_scan_tiles, scan.shared_scan_bitsliced_tiles,
           scan.shared_scan_dynamic_tiles)
    for n in SCAN_NS:
        values = rng.integers(0, 1 << width, size=n).astype(np.uint32)
        tiles = unpack.pack_device_kernel(
            torch.from_numpy(values.view(np.int32)).to(cuda_device), width).tiles
        for k in COMPARE_KS:
            kt = _keys(_compare_edge_keys(k, width, values, rng), cuda_device)
            for bo in (0, 3):
                want = scan.shared_scan_tiles_plain(tiles, kt, width, n, bo)
                before = [profiling.launch_count(fn) for fn in fns]
                _same(scan.shared_scan_tiles(tiles, kt, width, n, bo), want)
                assert [profiling.launch_count(fn) - b for fn, b in zip(fns, before)] == \
                    _compare_launches(width, k), (width, k)
                _same(_compare_launch(tiles, kt, width, n, bo), want)
                _same(scan.shared_scan_bitsliced_tiles(tiles, kt, width, n, bo), want)


@pytest.mark.parametrize("width", [9, 31])
def test_staged_kernels_walk_many_tiles_a_cta(cuda_device, width):
    # many runs of tiles, each CTA's run (3-8 tiles here) turning its ring
    # of stages more than once
    n = {9: 40_000_003, 31: 10_000_019}[width]
    values = _values(width, n, width + 600, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    for lo, k in ((0, 8), (5, 33)):
        _same(scan.interval_scan_tiles(tiles, lo, k, width, n),
              scan.interval_scan_tiles_plain(tiles, lo, k, width, n))
    for keys in ([0, int(values[7]), 1 << width], [int(values[3])]):
        kt = _keys(keys, cuda_device)
        _same(_compare_launch(tiles, kt, width, n, 1),
              scan.shared_scan_tiles_plain(tiles, kt, width, n, 1))


def test_refused_interval_and_compare_launches_raise(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    bits = torch.empty((1025, 8, 128), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(1025, dtype=torch.int64, device=cuda_device)
    keys = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    for k, w in ((0, 9), (1025, 9), (8, 0), (8, 32)):
        # no keys, more than a launch's counters hold, widths outside 1-31
        with pytest.raises(RuntimeError, match="sss_interval_scan"):
            _cuda.launch("sss_interval_scan", cuda_device, tiles.data_ptr(), 0, k,
                         bits.data_ptr(), counts.data_ptr(), 8 * 128, w, 100, 0, 1)
    for w in (0, 32):
        with pytest.raises(RuntimeError, match="sss_shared_scan"):
            _cuda.launch("sss_shared_scan", cuda_device, tiles.data_ptr(), keys.data_ptr(), 8,
                         bits.data_ptr(), counts.data_ptr(), 8 * 128, w, 100, 0)
    # rows the bulk copies cannot take: not 16-byte aligned
    with pytest.raises(RuntimeError, match="sss_interval_scan"):
        _cuda.launch("sss_interval_scan", cuda_device, tiles.data_ptr() + 4, 0, 8,
                     bits.data_ptr(), counts.data_ptr(), 8 * 128, 9, 100, 0, 1)
    with pytest.raises(RuntimeError, match="sss_shared_scan"):
        _cuda.launch("sss_shared_scan", cuda_device, tiles.data_ptr() + 4, keys.data_ptr(), 8,
                     bits.data_ptr(), counts.data_ptr(), 8 * 128, 9, 100, 0)
    for k in (0, 1025):
        with pytest.raises(ValueError, match="interval scan supports"):
            scan.interval_scan_tiles(tiles, 0, k, 9, 100)


def test_shift_canary_matches_plain(cuda_device):
    base, amounts = scan.canary_inputs(cuda_device)
    ptx, _ = scan.run_shift_canary(base, amounts)
    _same(ptx, scan.shift_canary_plain(base, amounts))
    assert scan.shift_saturates(cuda_device)


def test_slice_kernels_match_cpu_plain_path(cuda_device):
    width, n = 9, 32_000
    vals = harness.synth_modk(n, 8, width, device=cuda_device)
    counts_before = {f: profiling.launch_count(f) for f in (unpack.pack_tiles, unpack.unpack_tiles,
                                             scan.interval_scan_tiles, scan.shared_scan_tiles)}
    gdev = port.pack_device_kernel(vals, width)
    cdev = port.pack_device_kernel(vals.cpu(), width)
    _same(gdev.tiles.cpu(), cdev.tiles)
    for keys in (list(range(8)), [3], [3, 100, 7]):
        gbits, gcounts = port.shared_scan_device(gdev, keys)
        cbits, ccounts = port.shared_scan_device(cdev, keys)
        _same(gbits.cpu(), cbits)
        _same(gcounts.cpu(), ccounts)
    _same(port.unpack_device(gdev), vals)
    for f, before in counts_before.items():
        assert profiling.launch_count(f) > before, f.__name__
    assert harness.check_shared_scan(gdev, np.arange(8), vals)


def _arbitrary_key_sets(width, values):
    dom = 1 << width
    rng = np.random.default_rng(width + 7)
    spread = sorted(set(rng.integers(0, dom, size=8).tolist()))
    return [
        spread,
        [int(values[2]), int(values[2]), 0, dom - 1],               # duplicate key
        [dom, 1 << 31, 0xFFFFFFFF, int(values[4])],                 # out of domain
        [v % dom for v in (0, 2, 4, 6, 1, 3)],                      # clustered
        rng.integers(0, min(dom, 700), size=33).tolist(),           # one 48-row chunk
        rng.integers(0, min(dom, 700), size=64).tolist() + [dom],  # 32-row chunks
    ]


@pytest.mark.parametrize("width", WIDTHS)
def test_arbitrary_key_kernels_match_plain(cuda_device, width):
    values = _values(width, N, width + 40, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    offset = 2  # a shard whose tail block lands two blocks later
    for keys in _arbitrary_key_sets(width, values.cpu()):
        kt = _keys(keys, cuda_device)
        for bo in (0, offset):
            _same(scan.shared_scan_bitsliced_tiles(tiles, kt, width, N, bo),
                  scan.shared_scan_bitsliced_tiles_plain(tiles, kt, width, N, bo))
            _same(scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, N, bo),
                  scan.shared_scan_bitsliced_static_tiles_plain(tiles, keys, width, N, bo))
            _same(scan.windowed_scan_tiles(tiles, keys, width, N, bo),
                  scan.windowed_scan_tiles_plain(tiles, keys, width, N, bo))


def test_arbitrary_key_kernels_past_1024_keys(cuda_device):
    # every wrapper launches once per 1024 rows
    width = 11
    tiles = unpack.pack_device_kernel(_values(width, N, 12, cuda_device), width).tiles
    keys = ((np.arange(1500) * 7) % 2100).tolist()
    kt = _keys(keys, cuda_device)
    ref = scan.shared_scan_tiles_plain(tiles, kt, width, N)
    _same(scan.shared_scan_bitsliced_tiles(tiles, kt, width, N), ref)
    _same(scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, N), ref)
    _same(scan.windowed_scan_tiles(tiles, keys, width, N), ref)


def _with_edges(keys, width):
    """keys with a duplicate of the first across passes of 64 rows and
    launches of 1024, keys past the domain and a key of its top window."""
    keys, dom = [int(x) for x in keys], 1 << width
    k = len(keys)
    for at, key in ((k - 1, keys[0]), (k // 2, keys[0]), (1, dom), (2, 0xFFFFFFFF), (3, dom - 1)):
        if at < k:
            keys[at] = key
    return keys


def _window_edge_sets(width, values, k):
    dom = 1 << width
    rng = np.random.default_rng(width * 4099 + k)
    base = int(values[5]) // 32 * 32
    return {
        "one window": (base + rng.integers(0, min(32, dom), size=k)) % dom,
        "a window each": (32 * np.arange(k) + np.arange(k) % 32) % dom,  # 1024 windows from 15 bits
        "top windows": dom - 1 - rng.integers(0, min(64, dom), size=k),
        "drawn": values[rng.integers(0, len(values), size=k)],
    }


@pytest.mark.parametrize("width", [1, 5, 12, 13, 17, 18, 31])
def test_windowed_lookup_edges_match_plain(cuda_device, width):
    # each side of the direct window table (17) and the search (18), k around
    # a pass of 64 rows and a launch of 1024, a nonzero block_offset
    values = _values(width, N, width + 90, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    for k in (1, 8, 64, 65, 1024, 1025):
        for name, keys in _window_edge_sets(width, values.cpu().numpy().view(np.uint32), k).items():
            keys = _with_edges(keys, width)
            kt = _keys(keys, cuda_device)
            arr = np.asarray(keys, np.uint32)
            for bo in (0, 3):
                want = scan.shared_scan_tiles_plain(tiles, kt, width, N, bo)
                before = profiling.launch_count(scan.windowed_scan_tiles)
                _same(scan.windowed_scan_tiles(tiles, arr, width, N, bo), want)
                assert profiling.launch_count(scan.windowed_scan_tiles) == before + -(-k // 1024), \
                    (k, name)


@pytest.mark.parametrize("width", range(1, 32))
def test_runtime_key_tier_edges_match_plain(cuda_device, width):
    # CUDA keys through the fold, and through the route (the fold, or the
    # lookup where pick_route sends them): duplicates, keys past the
    # domain, k around a launch
    values = _values(width, N, width + 60, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    rng = np.random.default_rng(width)
    host = values.cpu().numpy().view(np.uint32)
    for k in (5, 8, 64, 128, 1025) + ((1024,) if width == 31 else ()):
        keys = _with_edges(host[rng.integers(0, N, size=k)], width)
        kt = _keys(keys, cuda_device)
        want = scan.shared_scan_bitsliced_tiles_plain(tiles, kt, width, N, 2)
        fns = (scan.shared_scan_tiles, scan.shared_scan_bitsliced_tiles,
               scan.shared_scan_dynamic_tiles)
        before = [profiling.launch_count(f) for f in fns]
        _same(scan.shared_scan_bitsliced_tiles(tiles, kt, width, N, 2), want)
        assert [profiling.launch_count(f) - b for f, b in zip(fns, before)] == \
            [0, -(-k // 1024), 0], k
        before = [profiling.launch_count(f) for f in fns]
        _same(scan.shared_scan_tiles(tiles, kt, width, N, 2), want)
        assert [profiling.launch_count(f) - b for f, b in zip(fns, before)] == \
            _compare_launches(width, k), k


@pytest.mark.parametrize("k", [1, 4, 5, 128, 129, 1024])
def test_static_fold_edges_match_plain(cuda_device, k):
    # a partial quad of keys (k = 1, 5, 129), whole quads (4, 128), a full
    # launch (1024); duplicates, keys past the domain, a block_offset
    for width in WIDTHS:
        values = _values(width, N, width + k, cuda_device)
        tiles = unpack.pack_device_kernel(values, width).tiles
        keys = np.random.default_rng(k + width).integers(0, 2 << width, size=k).tolist()
        keys[: min(k, 4)] = [int(values[3]), int(values[3]), 0xFFFFFFFF, 1 << width][: min(k, 4)]
        for bo in (0, 2):
            before = profiling.launch_count(scan.shared_scan_bitsliced_static_tiles)
            _same(scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, N, bo),
                  scan.shared_scan_bitsliced_static_tiles_plain(tiles, keys, width, N, bo))
            assert profiling.launch_count(scan.shared_scan_bitsliced_static_tiles) == before + 1


@pytest.mark.parametrize("width", [9, 31])
def test_static_fold_masks_past_48kb_of_shared_memory(cuda_device, width):
    # 1024 keys' plane masks take (width + 1) * 4 KB: 40 KB at width 9 (one
    # stage a CTA), 128 KB at width 31 (staged a chunk at a time)
    tiles = unpack.pack_device_kernel(_values(width, N, 31, cuda_device), width).tiles
    keys = np.random.default_rng(1).integers(0, 1 << width, size=1024).tolist()
    if width == 31:
        assert len(keys) * (width + 1) * 4 > 48 * 1024
    _same(scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, N),
          scan.shared_scan_bitsliced_static_tiles_plain(tiles, keys, width, N))


def test_refused_static_launch_raises(cuda_device):
    width, n = 9, 1000
    tiles = torch.zeros((width, 8, 128), dtype=torch.int32, device=cuda_device)
    keys = torch.zeros(1025, dtype=torch.int32, device=cuda_device)
    bits = torch.empty((1025, 8, 128), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(1025, dtype=torch.int64, device=cuda_device)
    for k, w in ((1025, width), (0, width), (8, 32)):
        # more keys than a launch's counters hold, none, a width past 31
        with pytest.raises(RuntimeError, match="sss_bitsliced_static_fold"):
            _cuda.launch("sss_bitsliced_static_fold", cuda_device, tiles.data_ptr(),
                         keys.data_ptr(), k, bits.data_ptr(), counts.data_ptr(), 8 * 128, w, n,
                         0)


def test_refused_windowed_launch_raises(cuda_device):
    width, n = 9, 1000
    tiles = torch.zeros((width, 8, 128), dtype=torch.int32, device=cuda_device)
    plan = torch.zeros(8192, dtype=torch.int32, device=cuda_device)
    bits = torch.empty((1025, 8, 128), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(1025, dtype=torch.int64, device=cuda_device)
    for k, nwin, nd, ndup, w in ((1025, 1, 1, 0, width), (0, 0, 0, 0, width),
                                 (8, 1, 1, 0, 32), (8, 2, 1, 0, width), (8, 1, 9, 0, width)):
        # more rows than a launch's counters hold, none, a width past 31,
        # fewer distinct keys than windows, more than rows
        with pytest.raises(RuntimeError, match="sss_windowed_lookup"):
            _cuda.launch("sss_windowed_lookup", cuda_device, tiles.data_ptr(), plan.data_ptr(), k,
                         nwin, nd, ndup, bits.data_ptr(), counts.data_ptr(), 8 * 128, w, n, 0)


def test_dispatcher_launches_each_tier(cuda_device):
    width, n = 9, 32_000
    vals = harness.synth_modk(n, 512, width, device=cuda_device)
    dev = port.pack_device_kernel(vals, width)
    spread8 = [3, 70, 141, 200, 262, 333, 400, 511]
    cases = [
        (list(range(8)), "interval", scan.interval_scan_tiles),
        ([0, 2, 4, 6], "fold", scan.shared_scan_bitsliced_tiles),
        (spread8, "fold", scan.shared_scan_bitsliced_tiles),
        ([5, 300], "compare", scan.shared_scan_tiles),
        (torch.tensor(spread8, dtype=torch.int32, device=cuda_device), "fold",
         scan.shared_scan_bitsliced_tiles),
        (torch.tensor([5, 300], dtype=torch.int32, device=cuda_device), "compare",
         scan.shared_scan_tiles),
    ]
    for keys, tier, fn in cases:
        lo, _ = scan.interval_or_keys(keys)
        assert tier == ("interval" if lo is not None else scan.pick_route(width, len(keys)))
        before = profiling.launch_count(fn)
        bits, counts = port.shared_scan_device(dev, keys)
        assert profiling.launch_count(fn) == before + 1, (keys, fn.__name__)
        host = scan._host_keys(keys)
        assert counts.tolist() == [int((vals == int(key)).sum()) for key in host.view(np.int32)]
        assert harness.check_shared_scan(dev, keys, vals)


@pytest.mark.parametrize("width", [20, 31])
def test_dispatcher_host_keys_take_the_window_lookup(cuda_device, width):
    # 1030 keys, a window each, with a duplicate and a key past the domain:
    # as host keys the route's window lookup for the first 1024
    # (pick_route(width, 1024, True)) and the compare kernel for the last
    # 6; as a CUDA tensor the dynamic scan's lookup for the first 1024
    vals = _values(width, N, width + 800, cuda_device)
    dev = port.pack_device_kernel(vals, width)
    keys = [32 * i + i % 32 for i in range(1030)]
    keys[:3] = [int(vals[5]), int(vals[5]), 0xFFFFFFFF]
    kt = _keys(keys, cuda_device)
    want_bits, want_counts = scan.shared_scan_tiles_plain(dev.tiles, kt, width, N)
    fns = (scan.windowed_scan_tiles, scan.shared_scan_dynamic_tiles, scan.shared_scan_tiles)
    assert scan.pick_route(width, 1024, True) == "window"
    for given, ran in ((keys, [1, 0, 1]), (kt, [0, 1, 1])):
        before = [profiling.launch_count(f) for f in fns]
        bits, counts = port.shared_scan_device(dev, given)
        assert [profiling.launch_count(f) - b for f, b in zip(fns, before)] == ran
        _same(bits, scan.bits_to_canonical(want_bits, N))
        _same(counts, want_counts)


def test_cuda_keys_never_reach_the_host(cuda_device, monkeypatch):
    width, n = 9, 32_000
    dev = port.pack_device_kernel(_values(width, n, 5, cuda_device), width)
    keys = torch.tensor([3, 70, 141, 200, 262, 333, 400, 511], dtype=torch.int32,
                        device=cuda_device)
    expect = port.shared_scan_device(dev, keys.cpu())
    before = profiling.launch_count(scan.shared_scan_bitsliced_tiles)

    def no_host(_):
        raise AssertionError("runtime keys were read on the host")

    monkeypatch.setattr(scan, "_host_keys", no_host)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any device-to-host copy raises
    try:
        bits, counts = port.shared_scan_device(dev, keys)
        bits1, count1 = port.scan_device(dev, keys[3:4])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert profiling.launch_count(scan.shared_scan_bitsliced_tiles) == before + 1
    _same(bits, expect[0])
    _same(counts, expect[1])
    _same(bits1, expect[0][3])
    _same(count1, expect[1][3])


def test_wrappers_refuse_mixed_devices(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        scan.shared_scan_tiles(tiles, torch.zeros(1, dtype=torch.int32), 9, 100)


# ---------------------------------------------------------------------------
# the query path: range scan, conjunction, member scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_range_scan_kernel_matches_plain(cuda_device, width):
    values = _values(width, N, width + 60, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    lows = [0, 1, dom - 1, 5, 3, 0xFFFFFFF0]
    highs = [dom, 0, 2, 5, 1 << 31, 0]  # [1, 2^32), a wrapped span, empty, hi = 2^32
    lo_t, hi_t = _keys(lows, cuda_device), _keys(highs, cuda_device)
    for bo in (0, 2):
        _same(scan.range_scan_tiles(tiles, lo_t, hi_t, width, N, bo),
              scan.range_scan_tiles_plain(tiles, lo_t, hi_t, width, N, bo))
    ref = ((values.to(torch.int64) & 0xFFFFFFFF) >= 1)
    assert int(scan.range_scan_tiles(tiles, lo_t, hi_t, width, N)[1][1]) == int(ref.sum())


# a stage of the staged kernel's ring holds sum(widths) words a block: up to
# 56 in tiles of 256 blocks (flight 1's 22), up to 112 in tiles of 128 (the
# eight mixed widths' 93), past that in tiles of 64 (113, and 248 for eight
# 31-bit columns)
CONJ_WIDTHS = [(9,), (1, 31), (2, 16, 17), (1, 2, 9, 16, 17, 31, 5, 12), (12, 6, 4),
               (31,) * 8, (31, 31, 31, 20)]


@pytest.mark.parametrize("widths", CONJ_WIDTHS)
def test_conj_kernel_matches_plain(cuda_device, widths):
    # 8 columns of 8 different widths in the last case; hi <= lo is empty
    tiles, lows, highs = [], [], []
    for i, width in enumerate(widths):
        values = _values(width, N, 70 + i, cuda_device)
        tiles.append(unpack.pack_device_kernel(values, width).tiles)
        dom = 1 << width
        lows.append(dom // 4 if i % 3 else 0)
        highs.append(dom - dom // 5 if i % 3 else dom)
    for lo, hi, bo in ((lows, highs, 0), (lows, highs, 2), ([1] + lows[1:], [1] + highs[1:], 0),
                       ([3] + lows[1:], [2] + highs[1:], 0)):
        _same(conj.conj_range_scan_tiles(tiles, lo, hi, widths, N, bo),
              conj.conj_range_scan_tiles_plain(tiles, np.asarray(lo, np.uint32),
                                               np.asarray(hi, np.uint32), widths, N, bo))


SPAN_N = 40 * 128 * 32 + 17  # 5121 blocks: 48 block rows, the last 7 padding
SPANS = [(0, 8), (16, 8), (8, 32), (40, 8), (0, 48)]  # start, middle, the padded end, whole
# one block row: fewer blocks than one tile of the staged conjunction, so
# less than one run; in the middle and at the padded end
SMALL_SPANS = [(21, 1), (47, 1)]


@pytest.mark.parametrize("widths", CONJ_WIDTHS[1:3] + CONJ_WIDTHS[4:])
def test_conj_kernel_span_matches_plain_and_the_whole_column(cuda_device, widths):
    tiles, lows, highs = [], [], []
    for i, width in enumerate(widths):
        tiles.append(unpack.pack_device_kernel(_values(width, SPAN_N, 80 + i, cuda_device),
                                               width).tiles)
        lows.append((1 << width) // 8)
        highs.append((1 << width) - (1 << width) // 6)
    full_bits, _ = conj.conj_range_scan_tiles(tiles, lows, highs, widths, SPAN_N)
    lo, hi = np.asarray(lows, np.uint32), np.asarray(highs, np.uint32)
    for start, count in SPANS + SMALL_SPANS:
        bits, total = conj.conj_range_scan_tiles(tiles, lows, highs, widths, SPAN_N,
                                                 rows=(start, count))
        _same((bits, total), conj.conj_range_scan_tiles_plain(tiles, lo, hi, widths, SPAN_N,
                                                              rows=(start, count)))
        want = torch.zeros_like(full_bits)
        want[start : start + count] = full_bits[start : start + count]
        _same(bits, want)
        assert int(total) == int(bitvector.popcount(want.reshape(-1)))


def _conj_columns(widths, n, seed, device):
    tiles, lows, highs = [], [], []
    for i, width in enumerate(widths):
        tiles.append(unpack.pack_device_kernel(_values(width, n, seed + i, device), width).tiles)
        dom = 1 << width
        lows.append(dom // 7)
        highs.append(dom - dom // 3)
    return tiles, lows, highs


def _conj_launches(fn):
    """fn()'s result, and how many conjunction launches it counted."""
    before = profiling.counters().get("launches.conj_range_scan_tiles", 0)
    out = fn()
    torch.cuda.synchronize()
    return out, profiling.counters().get("launches.conj_range_scan_tiles", 0) - before


def test_conj_kernel_runs_of_tiles_and_a_ragged_tile(cuda_device):
    # flight 1's widths over 1171 block rows: 149,888 blocks, 585 tiles of
    # 256 and one of 128, taken by CTAs in runs; the last 1000 values padding
    widths, n = (12, 6, 4), 1171 * 128 * 32 - 1000
    tiles, lows, highs = _conj_columns(widths, n, 120, cuda_device)
    lo, hi = np.asarray(lows, np.uint32), np.asarray(highs, np.uint32)
    for bo in (0, 3):
        (bits, total), launches = _conj_launches(
            lambda: conj.conj_range_scan_tiles(tiles, lows, highs, widths, n, bo))
        assert launches == 1
        _same((bits, total), conj.conj_range_scan_tiles_plain(tiles, lo, hi, widths, n, bo))
        assert int(total) == int(bitvector.popcount(bits.reshape(-1)))


def _member_cases(width, values):
    """(body name, call) for every member body: call(fn, tiles, bo) runs the
    body's wrapper or plain version ``fn``."""
    dom = 1 << width
    rng = np.random.default_rng(width + 90)
    v3 = int(values[3])
    spread = rng.integers(0, dom, size=12).tolist() + [0, v3, v3, dom]
    keys = _keys(spread, values.device)
    padded = member._pad_keys(keys, 32)
    bases, pops = member.member_window_plan(
        np.asarray([v % dom for v in (0, 2, 4, 6, 31, 40, 77)] + [int(values[7]), dom + 1],
                   np.uint32))
    win = _keys(np.stack([bases, pops], axis=1), values.device)
    clustered = np.concatenate([np.arange(0, dom, 64)[:40] + 3, [int(values[5]), dom]])
    cb, cp = member.member_window_plan(clustered.astype(np.uint32))
    cwin = np.stack([cb, cp], axis=1)
    cwin = np.concatenate([cwin, np.zeros(((-len(cb)) % 32, 2), np.int64)])
    cwin = _keys(cwin, values.device)
    # the table build's edges: unsorted and unaligned windows, one
    # straddling 2^width, one past 2^32 - 32 (its popmask wraps to value
    # 4), a base repeated across two chunks of 4, zero-popmask padding
    v = [int(x) for x in values[:8].tolist()]
    edge = [(v[1], 0b1011), (max(v[2] - 5, 0), 0xF0F0F0F1), ((dom - 7) % (1 << 32), 0xFFFF),
            (0xFFFFFFF0, (1 << 20) | (1 << 3)), (dom + 64, 0xFFFFFFFF), (v[1], 1 << 4),
            (v[6] & ~31, 1 << (v[6] & 31)), (0, 0)]
    ewin = _keys(edge, values.device)
    echunked = _keys(edge + edge[:2] + [(0, 0)] * 2, values.device)
    cases = [
        ("compare", lambda fn, t, bo: fn(t, keys, width, N, bo)),
        ("chunked_compare", lambda fn, t, bo: fn(t, padded, width, N, 32, bo)),
        ("window", lambda fn, t, bo: fn(t, win, width, N, bo)),
        ("chunked_window", lambda fn, t, bo: fn(t, cwin, width, N, 32, bo)),
        ("window", lambda fn, t, bo: fn(t, ewin, width, N, bo)),
        ("chunked_window", lambda fn, t, bo: fn(t, echunked, width, N, 4, bo)),
        ("compare", lambda fn, t, bo: fn(t, keys[:1], width, N, bo)),
        ("ortree", lambda fn, t, bo: fn(t, width, N, tuple(spread), bo)),
        ("bitsliced", lambda fn, t, bo: fn(t, padded, width, N, 32, bo)),
    ]
    if width <= member.MAX_DOMAIN_WIDTH:
        cases.append(("domain", lambda fn, t, bo: fn(t, keys, width, N, bo)))
    return cases


@pytest.mark.parametrize("width", WIDTHS)
def test_member_kernels_match_plain(cuda_device, width):
    values = _values(width, N, width + 80, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    for name, call in _member_cases(width, values):
        wrapper = getattr(member, f"_member_{name}_tiles")
        plain = getattr(member, f"_member_{name}_tiles_plain")
        for bo in (0, 2):
            before = profiling.launch_count(wrapper)
            _same(call(wrapper, tiles, bo), call(plain, tiles, bo))
            assert profiling.launch_count(wrapper) == before + 1, name


def _operand_rows(width, kind, rows, v):
    """Keys (spread over twice the domain, duplicates, a column value) or
    windows (any base below 2^width + 64, any popmask, some empty,
    duplicate bases) of ``rows`` rows."""
    rng = np.random.default_rng(rows + width)
    if kind == "keys":
        keys = rng.integers(0, 2 << width, size=rows)
        keys[rows // 2:: 97] = keys[0]
        keys[-1] = v[9]
        return keys
    bases = rng.integers(0, (1 << width) + 64, size=rows)
    bases[rows // 2:: 89] = bases[0]
    pops = rng.integers(0, 1 << 32, size=rows)
    pops[:: 13] = 0
    bases[-1], pops[-1] = max(int(v[4]) - 2, 0), 0b100
    return np.stack([bases, pops], axis=1)


@pytest.mark.parametrize("width", [1, 5, 9, 16, 17, 20, 31])
def test_member_operand_tables_match_plain(cuda_device, width):
    # the table the compare and window kernels build on the card, bit for
    # bit the plain build's (one CTA's bitmap, one CTA's sort up to 4096
    # rows, chunks and merge passes past it); the kernels' rows equal the
    # plain table's lookup, fused bitmap (up to MEMBER_FUSED_ROWS rows) or
    # not
    values = _values(width, N, width + 95, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    v = values.cpu().numpy().view(np.uint32)
    for kind in ("keys", "windows"):
        # around MEMBER_FUSED_ROWS (256 rows: 256 keys, 128 windows); 1025
        # keys before 4097: a small search table's launch must not cap the
        # chunked sort's shared memory
        for rows in (1, 4, 128, 129, 256, 257, 1025, 4097, 4096, 9000):
            a = _keys(_operand_rows(width, kind, rows, v), cuda_device)
            arg = {"keys": a} if kind == "keys" else {"win": a.reshape(-1, 2)}
            table = member.member_operand_table(width, **arg)
            plain = member.member_operand_table_plain(width, **{k: t.cpu() for k, t in arg.items()})
            _same(table.cpu(), plain)
            lookup = (member._bitmap_row_plain if width <= member.MAX_DOMAIN_WIDTH
                      else member._search_row_plain)
            for bo in (0, 2):
                want = member._member_finish(
                    lookup(scan._block_values_plain(tiles, width), plain.to(cuda_device)), N, bo)
                if kind == "keys":
                    got = member._member_compare_tiles(tiles, a, width, N, bo)
                else:
                    got = member._member_window_tiles(tiles, a.reshape(-1, 2), width, N, bo)
                _same(got, want)


def test_member_ortree_whole_domain_and_out_of_domain(cuda_device):
    width = 8
    values = _values(width, N, 3, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    bits, count = member._member_ortree_tiles(tiles, width, N, tuple(range(256)))
    _same(bits, member._member_ortree_tiles_plain(tiles, width, N, tuple(range(256)))[0])
    assert int(count) == N
    bits, count = member._member_ortree_tiles(tiles, width, N, (256, 300, 0xFFFFFFFF))
    assert int(count) == 0 and not bits.any()


@pytest.mark.parametrize("width", [15, 16, 17, 18])
def test_member_lookup_width_switch(cuda_device, width):
    # the bitmap up to width 16, the search from 17: spread sets with a
    # duplicate and keys past the domain, one window, a block_offset
    values = _values(width, N, width + 90, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    v = values.cpu().numpy().view(np.uint32)
    rng = np.random.default_rng(width)
    spread = rng.integers(0, 1 << width, size=200).tolist() + v[:40].tolist()
    for keys in (spread + [v[0], 1 << width, 0xFFFFFFFF], [int(v[7])], [int(v[7]) | 31]):
        for bo in (0, 2):
            before = profiling.launch_count(member._member_ortree_tiles)
            bits, count = member._member_ortree_tiles(tiles, width, N, keys, bo)
            _same((bits, count), member._member_ortree_tiles_plain(tiles, width, N, keys, bo))
            assert profiling.launch_count(member._member_ortree_tiles) == before + 1
            if bo == 0:
                assert int(count) == int(np.isin(v, np.asarray(keys, np.uint32)).sum())


def _keys_in_windows(v, nwin: int) -> list:
    """2000 of the column's values, then one key in each of the lowest
    windows they miss, to nwin 32-aligned windows in all."""
    keys = v[:2000].tolist()
    wins = {key >> 5 for key in keys}
    w = 0
    while len(wins) < nwin:
        if w not in wins:
            wins.add(w)
            keys.append(32 * w + w % 32)
        w += 1
    return keys


@pytest.mark.parametrize("width", [17, 20, 31])
def test_member_lookup_search_table_past_shared_memory(cuda_device, width):
    # the search table in shared memory up to 4096 windows, in device
    # memory past it: 4095, 4096 and 4097 windows (P = 4096, 4096, 8192;
    # width 17 has 4096 windows in all), far past the OR-tree tier's
    # largest set in the redesign sweep
    values = _values(width, N, width + 91, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    v = values.cpu().numpy().view(np.uint32)
    for nwin in (4095, 4096, 4097)[: 2 if width == 17 else 3]:
        keys = _keys_in_windows(v, nwin)
        assert len(member.member_window_plan(keys)[0]) == nwin
        table = member.member_set_table(width, member._ortree_patterns(width, keys))
        assert table.shape[1] == (4096 if nwin <= 4096 else 8192)
        bits, count = member._member_ortree_tiles(tiles, width, N, keys)
        _same((bits, count), member._member_ortree_tiles_plain(tiles, width, N, keys))
        assert int(count) == int(np.isin(v, np.asarray(keys, np.uint32)).sum())


@pytest.mark.parametrize("width", [1, 9, 17, 31])
def test_member_bitsliced_body_is_the_keys_lookup(cuda_device, width):
    # the bit-sliced body launches the compare kernel's table and lookup
    # (one launch, counted by the bit-sliced wrapper): k around a chunk of
    # 32 (31, 32, 33 and 64 keys, padded with 0xFFFFFFFF), whole chunks of
    # 8, duplicates, keys past the domain, 0xFFFFFFFF; past width 16 the
    # search, its P counting the padding
    values = _values(width, N, width + 97, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    v = values.cpu().numpy().view(np.uint32)
    dom = 1 << width
    rng = np.random.default_rng(width)
    for k in (31, 32, 33, 64):
        keys = rng.integers(0, 2 * dom, size=k - 4).tolist() + [int(v[3]), int(v[3]), dom,
                                                                 0xFFFFFFFF]
        for krows in (min(k, 32), 8):
            padded = member._pad_keys(_keys(keys, cuda_device), krows)
            for bo in (0, 2):
                before = (profiling.launch_count(member._member_bitsliced_tiles),
                          profiling.launch_count(member._member_compare_tiles))
                got = member._member_bitsliced_tiles(tiles, padded, width, N, krows, bo)
                assert (profiling.launch_count(member._member_bitsliced_tiles),
                        profiling.launch_count(member._member_compare_tiles)) == \
                    (before[0] + 1, before[1])
                _same(got, member._member_bitsliced_tiles_plain(tiles, padded, width, N, krows,
                                                                bo))
        got = member._member_bitsliced_tiles(tiles, padded, width, N, krows)
        assert int(got[1]) == int(np.isin(v, np.asarray(keys, np.uint32)).sum())


def test_member_runtime_tiers_never_reach_the_host(cuda_device, monkeypatch):
    width, n = 9, 32_000
    vals = harness.synth_modk(n, 512, width, device=cuda_device)
    dev = port.pack_device_kernel(vals, width)
    cases = [(4, member._member_compare_tiles), (16, member._member_bitsliced_tiles),
             (64, member._member_domain_tiles)]
    keys = {k: torch.tensor((np.arange(k) * 37 + 11) % 600, dtype=torch.int32, device=cuda_device)
            for k, _ in cases}
    expect = {k: member.member_scan_device(dev, keys[k].cpu()) for k, _ in cases}

    def no_host(_):
        raise AssertionError("runtime keys were read on the host")

    monkeypatch.setattr(member, "_host_keys", no_host)
    before = {fn: profiling.launch_count(fn) for _, fn in cases}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any device-to-host copy raises
    try:
        got = {k: member.member_scan_device(dev, keys[k]) for k, _ in cases}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for k, fn in cases:
        assert profiling.launch_count(fn) == before[fn] + 1, fn.__name__
        _same(got[k][0], expect[k][0])
        assert int(got[k][1]) == int(expect[k][1]) == int(torch.isin(
            vals.to(torch.int64), keys[k].to(torch.int64)).sum())


def test_member_dispatcher_launches_each_host_tier(cuda_device):
    width, n = 9, 32_000
    vals = harness.synth_modk(n, 512, width, device=cuda_device)
    dev = port.pack_device_kernel(vals, width)
    cases = [
        (list(range(100, 164)), "interval", scan.range_scan_tiles),
        ([0, 2, 4, 6], "window", member._member_window_tiles),
        ([3, 70, 141, 200, 262, 333, 400, 511], "ortree", member._member_ortree_tiles),
        ([5, 300], "compare", member._member_compare_tiles),
    ]
    for keys, tier, fn in cases:
        assert member.member_dispatch_tier(keys, width) == tier
        before = profiling.launch_count(fn)
        bits, count = port.member_scan_device(dev, keys)
        assert profiling.launch_count(fn) == before + 1, tier
        expect = torch.isin(vals.to(torch.int64), torch.tensor(keys, device=cuda_device))
        _same(bits, bitvector.from_bool(expect))
        assert int(count) == int(expect.sum())


def test_query_on_the_card_equals_the_plain_path(cuda_device):
    rng = np.random.default_rng(7)
    n = 40_000
    host = {name: rng.integers(0, 1 << w, n).astype(np.uint32)
            for name, w in (("price", 9), ("region", 5), ("status", 4))}
    widths = {"price": 9, "region": 5, "status": 4}
    gcols = {k: port.pack_device_kernel(torch.from_numpy(v.view(np.int32)).to(cuda_device),
                                        widths[k]) for k, v in host.items()}
    ccols = {k: port.layout.pack_device(v, widths[k], device="cpu") for k, v in host.items()}

    def trees(c):
        return [
            query.And(query.Range(c["price"], 100, 400), query.Range(c["region"], 2, 10),
                      query.Or(query.In(c["status"], [1, 4, 9]), query.Eq(c["status"], 0))),
            query.Or(query.Range(c["price"], 0, 50), query.Range(c["price"], 300, 350),
                     query.Range(c["price"], 500, 512), query.Eq(c["region"], 7)),
            query.Not(query.And(query.Eq(c["price"], 3), query.Eq(c["region"], 4),
                                query.Eq(c["status"], 5))),
            query.In(c["status"], [1, 4, 9, 0, 40]),
        ]

    for g, c in zip(trees(gcols), trees(ccols)):
        gbits, gcount = query.evaluate(g)
        cbits, ccount = query.evaluate(c)
        _same(gbits.cpu(), cbits)
        assert int(gcount) == int(ccount)
    with pytest.raises(TypeError):
        query.In(gcols["status"], torch.tensor([1, 2], device=cuda_device))


def test_refused_query_path_launches_raise(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    keys = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    bits = torch.empty((8, 128), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(RuntimeError, match="sss_member_domain"):
        # width 20: a table past the kernel's 16-bit cap
        _cuda.launch("sss_member_domain", cuda_device, tiles.data_ptr(), keys.data_ptr(), 4,
                     bits.data_ptr(), counts.data_ptr(), 8 * 128, 20, 100, 0)
    ptrs = np.full(9, tiles.data_ptr(), np.int64)
    w = np.full(9, 9, np.int32)
    lo = np.zeros(9, np.uint32)
    with pytest.raises(RuntimeError, match="sss_conj_range_scan"):
        _cuda.launch("sss_conj_range_scan", cuda_device, ptrs.ctypes.data, w.ctypes.data,
                     lo.ctypes.data, lo.ctypes.data, 9, bits.data_ptr(), counts.data_ptr(),
                     8 * 128, 8 * 128, 100, 0)
    with pytest.raises(RuntimeError, match="sss_conj_range_scan"):
        # a row stride shorter than the blocks scanned
        _cuda.launch("sss_conj_range_scan", cuda_device, ptrs.ctypes.data, w.ctypes.data,
                     lo.ctypes.data, lo.ctypes.data, 1, bits.data_ptr(), counts.data_ptr(),
                     8 * 128, 4 * 128, 100, 0)
    with pytest.raises(RuntimeError, match="sss_conj_range_scan"):
        # a column off 16 bytes: the TMA's refusal
        odd = np.full(1, tiles.data_ptr() + 4, np.int64)
        _cuda.launch("sss_conj_range_scan", cuda_device, odd.ctypes.data, w.ctypes.data,
                     lo.ctypes.data, lo.ctypes.data, 1, bits.data_ptr(), counts.data_ptr(),
                     4 * 128, 8 * 128, 100, 0)


# ---------------------------------------------------------------------------
# the aggregate path: select-accumulate, bit planes, MIN/MAX, masked
# ---------------------------------------------------------------------------

AGG_PAIRS = [(9, 9), (9, 16), (5, 17), (9, 31), (31, 12), (1, 20)]


def _agg_cases(wp, pvals):
    """Key sets: k = 1, 2, 4 and 32; key 0 over the padding, duplicates,
    keys >= 2^wp and 0xFFFFFFFF."""
    dom = 1 << wp
    v = [int(x) for x in pvals[:8].tolist()]
    rng = np.random.default_rng(wp)
    return [[v[0]], [0, dom], [v[1], v[1], 0xFFFFFFFF, 0],
            rng.integers(0, min(dom, 64), size=30).tolist() + [dom, v[2]]]


@pytest.mark.parametrize("wp,wm", AGG_PAIRS)
def test_aggregate_kernels_match_plain(cuda_device, wp, wm):
    pvals = _values(wp, N, wp + 100, cuda_device)
    ptiles = unpack.pack_device_kernel(pvals, wp).tiles
    mtiles = unpack.pack_device_kernel(_values(wm, N, wm + 101, cuda_device), wm).tiles
    for keys in _agg_cases(wp, pvals.cpu()):
        kt = _keys(keys, cuda_device)
        for bo in (0, 2):
            for fn in (aggregate.aggregate_scan_tiles, aggregate.aggregate_bitplane_tiles,
                       aggregate.minmax_scan_tiles):
                before = profiling.launch_count(fn)
                _same(fn(ptiles, mtiles, kt, wp, wm, N, bo),
                      getattr(aggregate, f"{fn.__name__}_plain")(ptiles, mtiles, kt, wp, wm, N, bo))
                assert profiling.launch_count(fn) == before + 1, fn.__name__
            _same(aggregate.aggregate_bitplane_static_tiles(ptiles, mtiles, keys, wp, wm, N, bo),
                  aggregate.aggregate_bitplane_static_tiles_plain(ptiles, mtiles, keys, wp, wm, N,
                                                                  bo))
    mask = (pvals.to(torch.int64) & 0xFFFFFFFF) % 3 == 1
    row = aggregate.bits_from_canonical(bitvector.from_bool(mask), ptiles.shape[1])
    _same(aggregate.masked_aggregate_tiles(mtiles, row, wm, N),
          aggregate.masked_aggregate_tiles_plain(mtiles, row, wm, N))


@pytest.mark.parametrize("wm", [9, 24, 31])
def test_masked_aggregate_span_matches_plain_and_the_whole_column(cuda_device, wm):
    mvals = _values(wm, SPAN_N, wm + 110, cuda_device)
    mtiles = unpack.pack_device_kernel(mvals, wm).tiles
    mask = (_values(5, SPAN_N, 111, cuda_device) % 3) == 1
    rows = torch.arange(SPAN_N, device=cuda_device) // (128 * 32)
    for start, count in SPANS:
        inside = mask & (rows >= start) & (rows < start + count)
        words = bitvector.from_bool(inside)
        row = aggregate.bits_from_canonical(words, mtiles.shape[1])
        span_row = aggregate.bits_from_canonical(words, mtiles.shape[1], (start, count))
        _same(span_row, row[start : start + count])
        whole = aggregate.masked_aggregate_tiles(mtiles, row, wm, SPAN_N)
        _same(aggregate.masked_aggregate_tiles(mtiles, span_row, wm, SPAN_N, (start, count)),
              whole)
        _same(aggregate.masked_aggregate_tiles_plain(mtiles, span_row, wm, SPAN_N,
                                                     (start, count)), whole)
        total, n = aggregate.masked_aggregate_device(
            port.DeviceColumn(wm, SPAN_N, mtiles), words, rows=(start, count))
        assert int(n) == int(inside.sum())
        assert int(total) == int((mvals.to(torch.int64) & 0xFFFFFFFF)[inside].sum())


def test_aggregate_sums_past_32_bits(cuda_device):
    # wm = 31, every value 2^31 - 1 and every row matching: per thread 32
    # values, per CTA 8192, in all ~4.3e14 (past 2^32 and 2^48)
    wp, wm, n = 3, 31, 200_000
    top = (1 << 31) - 1
    ptiles = unpack.pack_device_kernel(torch.full((n,), 5, dtype=torch.int32,
                                                  device=cuda_device), wp).tiles
    mtiles = unpack.pack_device_kernel(torch.full((n,), top, dtype=torch.int32,
                                                  device=cuda_device), wm).tiles
    kt = _keys([5, 0], cuda_device)
    want = [n * top, 0]
    for fn in (aggregate.aggregate_scan_tiles, aggregate.aggregate_bitplane_tiles):
        counts, sums = fn(ptiles, mtiles, kt, wp, wm, n)
        assert sums.tolist() == want and counts.tolist() == [n, 0]
    counts, sums = aggregate.aggregate_bitplane_static_tiles(ptiles, mtiles, [5, 0], wp, wm, n)
    assert sums.tolist() == want and counts.tolist() == [n, 0]
    counts, mins, maxs = aggregate.minmax_scan_tiles(ptiles, mtiles, kt, wp, wm, n)
    assert mins.tolist() == [top, 1 << 31] and maxs.tolist() == [top, 0]
    row = aggregate.bits_from_canonical(bitvector.from_bool(
        torch.ones(n, dtype=torch.bool, device=cuda_device)), ptiles.shape[1])
    count, total = aggregate.masked_aggregate_tiles(mtiles, row, wm, n)
    assert int(count) == n and int(total) == want[0]


def test_agg_lookup_largest_table(cuda_device):
    # wp = 16: the byte table's 64 KB of shared memory, past the 48 KB
    # default; keys at both ends of the domain, a duplicate and one past it;
    # wp = 17, the first width of the search
    for wp in (16, 17):
        dom = 1 << wp
        pvals = _values(wp, N, 131 + wp, cuda_device)
        pvals[:40] = dom - 1
        ptiles = unpack.pack_device_kernel(pvals, wp).tiles
        mtiles = unpack.pack_device_kernel(_values(20, N, 132, cuda_device), 20).tiles
        keys = [0, dom - 1, int(pvals[50]), int(pvals[50]), dom] + np.random.default_rng(
            wp).integers(0, dom, size=27).tolist()
        for bo in (0, 2):
            _same(aggregate.aggregate_bitplane_static_tiles(ptiles, mtiles, keys, wp, 20, N, bo),
                  aggregate.aggregate_bitplane_static_tiles_plain(ptiles, mtiles, keys, wp, 20, N,
                                                                  bo))


@pytest.mark.parametrize("wp", range(1, 32))
def test_agg_lookup_every_width_matches_plain(cuda_device, wp):
    # keys spread over the domain, key 0 over the padding, a duplicate, keys
    # >= 2^wp and 0xFFFFFFFF; measures of 1, 20 and 31 bits; a block_offset
    n = 4 * 256 * 32 + 5017  # full tiles, then a partial one
    dom = 1 << wp
    pvals = _values(wp, n, wp + 400, cuda_device)
    ptiles = unpack.pack_device_kernel(pvals, wp).tiles
    v = [int(x) for x in pvals[:3].tolist()]
    keys = [0, v[0], v[1], v[1], dom, 0xFFFFFFFF] + np.random.default_rng(wp).integers(
        0, dom, size=26).tolist()
    for wm in (1, 20, 31):
        mtiles = unpack.pack_device_kernel(_values(wm, n, wm + 401, cuda_device), wm).tiles
        for ks in (keys[:1], keys[:6], keys):
            for bo in (0, 2):
                before = profiling.launch_count(aggregate.aggregate_bitplane_static_tiles)
                _same(aggregate.aggregate_bitplane_static_tiles(ptiles, mtiles, ks, wp, wm, n, bo),
                      aggregate.aggregate_bitplane_static_tiles_plain(ptiles, mtiles, ks, wp, wm,
                                                                      n, bo))
                assert profiling.launch_count(aggregate.aggregate_bitplane_static_tiles) == \
                    before + 1


def test_agg_lookup_contention_columns(cuda_device):
    # every row on one key, 90% on one key, sorted runs: many lanes of a
    # warp on one slot's counters; sums past 2^32 within one CTA (wm = 31);
    # host keys and the same keys in device memory
    n = 8 * 256 * 32 + 77
    rng = np.random.default_rng(9)
    uniform = rng.integers(0, 32, n)
    columns = {"constant": np.full(n, 3), "skewed": np.where(rng.random(n) < 0.9, 3, uniform),
               "sorted": np.sort(uniform)}
    for wm in (20, 31):
        m = torch.from_numpy(rng.integers(0, 1 << wm, n).astype(np.uint32).view(np.int32))
        mtiles = unpack.pack_device_kernel(m.to(cuda_device), wm).tiles
        m64 = m.to(torch.int64) & 0xFFFFFFFF
        for label, p in columns.items():
            ptiles = unpack.pack_device_kernel(_keys(p, cuda_device), 5).tiles
            g = torch.from_numpy(p)
            want = torch.zeros(32, dtype=torch.int64).scatter_add_(0, g, m64)
            for keys in (list(range(32)), torch.arange(32, dtype=torch.int32, device=cuda_device)):
                fn = (aggregate.aggregate_bitplane_tiles if isinstance(keys, torch.Tensor)
                      else aggregate.aggregate_bitplane_static_tiles)
                counts, sums = fn(ptiles, mtiles, keys, 5, wm, n)
                assert counts.tolist() == torch.bincount(g, minlength=32).tolist(), label
                assert sums.tolist() == want.tolist(), label


@pytest.mark.parametrize("wp", range(1, 32))
def test_agg_device_lookup_every_width_matches_plain(cuda_device, wp):
    # the bit-plane tier for keys in device memory: the byte table up to 16
    # bits, each CTA's window or search past it; key 0 over the padding, a
    # duplicate, keys >= 2^wp and 0xFFFFFFFF, k = 1, 6 and 32; uniform,
    # constant, 90%-skewed and sorted predicates; measures of 1, 20 and 31
    # bits; a block_offset
    n = 4 * 256 * 32 + 5017  # full tiles, then a partial one
    dom = 1 << wp
    rng = np.random.default_rng(wp + 700)
    mtiles = {wm: unpack.pack_device_kernel(_values(wm, n, wm + 701, cuda_device), wm).tiles
              for wm in (1, 20, 31)}
    for label, p in _minmax_columns(wp, n, rng).items():
        ptiles = unpack.pack_device_kernel(_keys(p, cuda_device), wp).tiles
        keys = [0, int(p[1]), int(p[1]), dom, 0xFFFFFFFF, dom - 1] + rng.integers(
            0, dom, size=26).tolist()
        for ks in (keys[:1], keys[:6], keys):
            kt = _keys(ks, cuda_device)
            for wm, mt in mtiles.items():
                for bo in (0, 2):
                    before = profiling.launch_count(aggregate.aggregate_bitplane_tiles)
                    got = aggregate.aggregate_bitplane_tiles(ptiles, mt, kt, wp, wm, n, bo)
                    assert profiling.launch_count(aggregate.aggregate_bitplane_tiles) == before + 1
                    _same(got, aggregate.aggregate_bitplane_tiles_plain(ptiles, mt, kt, wp, wm,
                                                                        n, bo))
                    _same(got, aggregate.aggregate_bitplane_static_tiles(ptiles, mt, ks, wp, wm,
                                                                         n, bo))


@pytest.mark.parametrize("wp", [17, 20, 31])
def test_agg_device_lookup_window_and_search_past_16_bits(cuda_device, wp):
    # keys in device memory past the byte table: spread keys (a 16-bit
    # window separates them), keys whose windows meet at every shift (0 and
    # 2^(wp-1) below wp - 16, 4 and 5 above 0: each CTA's search), and both
    # at once; a sum past 2^32 within one CTA (wm = 31)
    n = 2 * 256 * 32 + 999
    dom = 1 << wp
    rng = np.random.default_rng(wp + 800)
    p = rng.integers(0, dom, n).astype(np.uint32)
    p[:64] = [0, 1 << (wp - 1), 4, 5] * 16
    ptiles = unpack.pack_device_kernel(_keys(p, cuda_device), wp).tiles
    spread = [int(x) for x in np.sort(rng.choice(dom, 16, replace=False))] + [int(p[100])]
    clash = [0, 1 << (wp - 1), 4, 5, int(p[100]), dom, 0xFFFFFFFF, 4]
    for wm in (20, 31):
        m = rng.integers(0, 1 << wm, n).astype(np.uint32)
        m[:64] = (1 << wm) - 1
        mtiles = unpack.pack_device_kernel(_keys(m, cuda_device), wm).tiles
        for keys in (spread, clash, clash + spread[:24]):
            kt = _keys(keys, cuda_device)
            for bo in (0, 2):
                _same(aggregate.aggregate_bitplane_tiles(ptiles, mtiles, kt, wp, wm, n, bo),
                      aggregate.aggregate_bitplane_tiles_plain(ptiles, mtiles, kt, wp, wm, n, bo))
    # every value of one CTA's tile on key 5, each 2^31 - 1
    top = (1 << 31) - 1
    ptiles = unpack.pack_device_kernel(torch.full((8192,), 5, dtype=torch.int32,
                                                  device=cuda_device), wp).tiles
    mtiles = unpack.pack_device_kernel(torch.full((8192,), top, dtype=torch.int32,
                                                  device=cuda_device), 31).tiles
    counts, sums = aggregate.aggregate_bitplane_tiles(ptiles, mtiles, _keys([5, 0, 5, dom],
                                                                          cuda_device),
                                                      wp, 31, 8192)
    assert counts.tolist() == [8192, 0, 8192, 0]
    assert sums.tolist() == [8192 * top, 0, 8192 * top, 0]


def _minmax_columns(wp, n, rng):
    """Predicate columns of n values at width wp: uniform, constant, 90% on
    one value, and sorted."""
    dom = 1 << wp
    uniform = rng.integers(0, dom, n).astype(np.uint32)
    return {"uniform": uniform, "constant": np.full(n, dom // 3, np.uint32),
            "skewed": np.where(rng.random(n) < 0.9, dom - 1, uniform).astype(np.uint32),
            "sorted": np.sort(uniform)}


@pytest.mark.parametrize("wp", range(1, 32))
def test_minmax_lookup_every_width_matches_plain(cuda_device, wp):
    # keys in device memory: key 0 over the padding, a duplicate, keys >=
    # 2^wp and 0xFFFFFFFF, the skewed column's hot value; uniform, constant,
    # 90%-skewed and sorted predicates; a measure that falls with the row
    # index (every value a new minimum: the load-first form's worst case)
    # and a uniform 31-bit one; a block_offset
    n = 4 * 256 * 32 + 5017  # full tiles, then a partial one
    dom = 1 << wp
    rng = np.random.default_rng(wp + 500)
    measures = {20: ((1 << 20) - 1 - np.arange(n) % (1 << 20)).astype(np.uint32),
                31: rng.integers(0, 1 << 31, n).astype(np.uint32)}
    mtiles = {wm: unpack.pack_device_kernel(_keys(m, cuda_device), wm).tiles
              for wm, m in measures.items()}
    for label, p in _minmax_columns(wp, n, rng).items():
        ptiles = unpack.pack_device_kernel(_keys(p, cuda_device), wp).tiles
        keys = [0, int(p[1]), int(p[1]), dom, 0xFFFFFFFF, dom - 1, dom // 3] + rng.integers(
            0, dom, size=25).tolist()
        for ks in (keys[:1], keys[:7], keys):
            kt = _keys(ks, cuda_device)
            for wm, mt in mtiles.items():
                for bo in (0, 2):
                    before = profiling.launch_count(aggregate.minmax_scan_tiles)
                    got = aggregate.minmax_scan_tiles(ptiles, mt, kt, wp, wm, n, bo)
                    assert profiling.launch_count(aggregate.minmax_scan_tiles) == before + 1
                    _same(got, aggregate.minmax_scan_tiles_plain(ptiles, mt, kt, wp, wm, n, bo))
        # the whole column against numpy (wm 20, every key)
        counts, mins, maxs = aggregate.minmax_scan_tiles(ptiles, mtiles[20], _keys(keys,
                                                                                   cuda_device),
                                                         wp, 20, n)
        m = measures[20].astype(np.int64)
        for j, key in enumerate(keys):
            sel = m[p == key]
            assert int(counts[j]) == sel.size, (label, key)
            assert int(mins[j]) == (int(sel.min()) if sel.size else 1 << 20), (label, key)
            assert int(maxs[j]) == (int(sel.max()) if sel.size else 0), (label, key)


@pytest.mark.parametrize("wp", [17, 20, 31])
def test_minmax_lookup_window_and_search_past_16_bits(cuda_device, wp):
    # keys in device memory past the byte table: spread keys (a 16-bit
    # window separates them), and keys whose windows meet at every shift
    # (0 and 2^(wp-1) at shifts below wp - 16, 4 and 5 at every shift
    # above 0), which leave each CTA the binary search
    n = 2 * 256 * 32 + 999
    dom = 1 << wp
    rng = np.random.default_rng(wp + 600)
    p = rng.integers(0, dom, n).astype(np.uint32)
    p[:64] = [0, 1 << (wp - 1), 4, 5] * 16
    ptiles = unpack.pack_device_kernel(_keys(p, cuda_device), wp).tiles
    mtiles = unpack.pack_device_kernel(_values(20, n, wp + 601, cuda_device), 20).tiles
    spread = [int(x) for x in np.sort(rng.choice(dom, 16, replace=False))] + [int(p[100])]
    clash = [0, 1 << (wp - 1), 4, 5, int(p[100]), dom, 0xFFFFFFFF, 4]
    for keys in (spread, clash, clash + spread[:24]):
        kt = _keys(keys, cuda_device)
        for bo in (0, 2):
            _same(aggregate.minmax_scan_tiles(ptiles, mtiles, kt, wp, 20, n, bo),
                  aggregate.minmax_scan_tiles_plain(ptiles, mtiles, kt, wp, 20, n, bo))


def test_refused_aggregate_launches_raise(cuda_device):
    wp, wm, n = 9, 20, 1000
    ptiles = torch.zeros((wp, 8, 128), dtype=torch.int32, device=cuda_device)
    mtiles = torch.zeros((wm, 8, 128), dtype=torch.int32, device=cuda_device)
    out = torch.zeros(33, dtype=torch.int64, device=cuda_device)
    host = np.zeros(33, np.uint32)
    for k, w in ((33, wp), (0, wp), (2, 32)):
        with pytest.raises(RuntimeError, match="sss_agg_lookup"):
            # 33 keys: more than the kernel's slots; no keys; width 32
            _cuda.launch("sss_agg_lookup", cuda_device, ptiles.data_ptr(), mtiles.data_ptr(),
                         host.ctypes.data, k, out.data_ptr(), out.data_ptr(), 8 * 128, w, wm, n,
                         0)
    keys = torch.zeros(33, dtype=torch.int32, device=cuda_device)
    for k, w, v in ((33, wp, wm), (0, wp, wm), (2, 32, wm), (2, wp, 32)):
        with pytest.raises(RuntimeError, match="sss_agg_device_lookup"):
            # more keys than the lookup's slots; no keys; a predicate or measure of 32 bits
            _cuda.launch("sss_agg_device_lookup", cuda_device, ptiles.data_ptr(),
                         mtiles.data_ptr(), keys.data_ptr(), k, out.data_ptr(), out.data_ptr(),
                         8 * 128, w, v, n, 0)
    with pytest.raises(RuntimeError, match="sss_agg_compare"):
        # 33 keys: more than the kernel's shared counters hold
        _cuda.launch("sss_agg_compare", cuda_device, ptiles.data_ptr(), mtiles.data_ptr(),
                     keys.data_ptr(), 33, out.data_ptr(), out.data_ptr(), 8 * 128, wp, wm, n, 0)
    for k, w, v in ((33, wp, wm), (0, wp, wm), (2, 32, wm), (2, wp, 32)):
        with pytest.raises(RuntimeError, match="sss_minmax_lookup"):
            # more keys than the lookup's slots; no keys; a predicate or measure of 32 bits
            _cuda.launch("sss_minmax_lookup", cuda_device, ptiles.data_ptr(), mtiles.data_ptr(),
                         keys.data_ptr(), k, out.data_ptr(), out.data_ptr(), out.data_ptr(),
                         8 * 128, w, v, n, 0)


def test_aggregate_dispatch_launches_each_tier(cuda_device):
    wp, wm, n = 5, 20, 40_000
    pv = _values(wp, n, 7, cuda_device)
    mv = _values(wm, n, 8, cuda_device)
    pdev, mdev = port.pack_device_kernel(pv, wp), port.pack_device_kernel(mv, wm)
    cpdev = port.layout.pack_device(pv.cpu(), wp)
    cmdev = port.layout.pack_device(mv.cpu(), wm)
    cases = [
        (list(range(32)), aggregate.aggregate_bitplane_static_tiles),
        ([3], aggregate.aggregate_scan_tiles),
        (torch.arange(8, dtype=torch.int32, device=cuda_device), aggregate.aggregate_bitplane_tiles),
        (torch.tensor([3, 7], dtype=torch.int32, device=cuda_device), aggregate.aggregate_scan_tiles),
    ]
    p64, m64 = pv.to(torch.int64), mv.to(torch.int64)
    for keys, fn in cases:
        before = profiling.launch_count(fn)
        sums, counts = port.aggregate_scan_device(pdev, mdev, keys)
        assert profiling.launch_count(fn) == before + 1, fn.__name__
        host = keys.cpu() if isinstance(keys, torch.Tensor) else torch.tensor(keys)
        csums, ccounts = port.aggregate_scan_device(cpdev, cmdev, host)
        _same(sums.cpu(), csums)
        _same(counts.cpu(), ccounts)
        assert counts.tolist() == [int((p64 == int(key)).sum()) for key in host]
        assert sums.tolist() == [int(m64[p64 == int(key)].sum()) for key in host]
    before = profiling.launch_count(aggregate.minmax_scan_tiles)
    mins, maxs, counts = port.minmax_scan_device(pdev, mdev, list(range(8)))
    assert profiling.launch_count(aggregate.minmax_scan_tiles) == before + 1
    for key in range(8):
        sel = m64[p64 == key]
        assert int(mins[key]) == int(sel.min()) and int(maxs[key]) == int(sel.max())


def test_aggregate_cuda_keys_never_reach_the_host(cuda_device, monkeypatch):
    wp, wm, n = 9, 20, 40_000
    pdev = port.pack_device_kernel(_values(wp, n, 9, cuda_device), wp)
    mdev = port.pack_device_kernel(_values(wm, n, 10, cuda_device), wm)
    sets = [torch.arange(8, dtype=torch.int32, device=cuda_device),
            torch.tensor([3, 70], dtype=torch.int32, device=cuda_device)]
    expect = [port.aggregate_scan_device(pdev, mdev, keys.cpu()) for keys in sets]
    expect_mm = port.minmax_scan_device(pdev, mdev, sets[1].cpu())

    def no_host(_):
        raise AssertionError("runtime keys were read on the host")

    monkeypatch.setattr(aggregate, "_host_keys", no_host)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any device-to-host copy raises
    try:
        got = [port.aggregate_scan_device(pdev, mdev, keys) for keys in sets]
        got_mm = port.minmax_scan_device(pdev, mdev, sets[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, e in zip(got, expect):
        _same(g[0], e[0])
        _same(g[1], e[1])
    for g, e in zip(got_mm, expect_mm):
        _same(g, e)


def test_masked_aggregate_over_query_on_the_card(cuda_device):
    rng = np.random.default_rng(7)
    n = 40_000
    widths = {"price": 9, "region": 5, "status": 4, "revenue": 20}
    host = {name: rng.integers(0, 1 << w, n).astype(np.uint32) for name, w in widths.items()}
    gcols = {k: port.pack_device_kernel(torch.from_numpy(v.view(np.int32)).to(cuda_device),
                                        widths[k]) for k, v in host.items()}
    where = query.And(query.Range(gcols["price"], 100, 400), query.Range(gcols["region"], 2, 10),
                      query.Or(query.In(gcols["status"], [1, 4, 9]),
                               query.Eq(gcols["status"], 0)))
    bits, count = query.evaluate(where)
    before = profiling.launch_count(aggregate.masked_aggregate_tiles)
    total, count2 = port.masked_aggregate_device(gcols["revenue"], bits)
    assert profiling.launch_count(aggregate.masked_aggregate_tiles) == before + 1
    v = host
    expect = ((v["price"] >= 100) & (v["price"] < 400) & (v["region"] >= 2) & (v["region"] < 10)
              & (np.isin(v["status"], [1, 4, 9]) | (v["status"] == 0)))
    assert int(count2) == int(count) == int(expect.sum())
    assert int(total) == int(v["revenue"][expect].astype(np.int64).sum())


def test_build_is_cached(cuda_device):
    path = _cuda.build()
    assert path == _cuda.library_path() and path.exists()
    assert _cuda.build() == path


# ---------------------------------------------------------------------------
# the histogram, the statistics and the zone maps
# ---------------------------------------------------------------------------


def _lo(lo, device):
    return _keys([lo], device)


@pytest.mark.parametrize("width", WIDTHS)
def test_histogram_kernels_match_plain(cuda_device, width):
    values = _values(width, N, width + 150, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    v0 = int(values[0])
    # the full domain, windows at 0 and at a value, past the domain and
    # wrapping past 2^32 (runtime lo only)
    cases = [(0, min(dom, 4096)), (v0, 5), (0, 49), (max(dom - 20, 0), 64), (dom, 32),
             ((1 << 32) - 3, 40)]
    for lo, k in cases:
        for bo in (0, 2):
            before = profiling.launch_count(scan.histogram_tiles)
            _same(scan.histogram_tiles(tiles, _lo(lo, cuda_device), k, width, N, bo),
                  scan.histogram_tiles_plain(tiles, lo, k, width, N, bo))
            assert profiling.launch_count(scan.histogram_tiles) == before + 1
            for fn in (scan._histogram_chunked_tiles, scan._histogram_span_tiles):
                before = profiling.launch_count(fn)
                _same(fn(tiles, lo, k, width, N, bo),
                      getattr(scan, f"{fn.__name__}_plain")(tiles, lo, k, width, N, bo))
                assert profiling.launch_count(fn) > before, fn.__name__


def test_histogram_kernels_count_every_value(cuda_device):
    # a clustered column (every lane of a warp on one bin) and a uniform
    # one; k = 4096 on the chunked programs and the span tier; a window at
    # 2^32 - 3, which the span tier counts as empty and a runtime lo wraps
    width, n = 12, 200_000
    top = (1 << 32) - 3
    for values in (torch.arange(n, device=cuda_device, dtype=torch.int32) // 4096,
                   _values(width, n, 5, cuda_device)):
        tiles = unpack.pack_device_kernel(values, width).tiles
        expect = torch.bincount(values.to(torch.int64), minlength=4096)
        _same(scan.histogram_tiles(tiles, _lo(0, cuda_device), 4096, width, n), expect)
        _same(scan._histogram_chunked_tiles(tiles, 0, 4096, width, n), expect)
        _same(scan._histogram_span_tiles(tiles, 0, 4096, width, n), expect)
        _same(scan._histogram_span_tiles(tiles, top, 40, width, n),
              torch.zeros(40, dtype=torch.int64, device=cuda_device))
        _same(scan.histogram_tiles(tiles, _lo(top, cuda_device), 40, width, n)[3:], expect[:37])


@pytest.mark.parametrize("width", range(1, 32))
def test_histogram_whole_window_and_masked_paths(cuda_device, width):
    # five tiles of 256 blocks, the last one partial: full tiles take the
    # unmasked paths, the last the masked one; a window over the whole
    # domain (widths <= 12) takes the path without subtract and compare,
    # one key short of it the window path; lo = 2^32 - 3 wraps (runtime lo)
    # or counts nothing (span tier); a block_offset moves the partial tile
    n = 4 * 256 * 32 + 5000
    values = _values(width, n, width + 300, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    cases = [(0, min(dom, 4096)), (0, min(dom, 4097) - 1), (0, 4096), (int(values[7]), 5),
             ((1 << 32) - 3, 40)]
    for lo, k in cases:
        for bo in (0, 2, 1024):
            _same(scan.histogram_tiles(tiles, _lo(lo, cuda_device), k, width, n, bo),
                  scan.histogram_tiles_plain(tiles, lo, k, width, n, bo))
            _same(scan._histogram_span_tiles(tiles, lo, k, width, n, bo),
                  scan._histogram_span_tiles_plain(tiles, lo, k, width, n, bo))
            _same(scan._histogram_chunked_tiles(tiles, lo, k, width, n, bo),
                  scan._histogram_chunked_tiles_plain(tiles, lo, k, width, n, bo))


@pytest.mark.parametrize("width", range(1, 32))
def test_chunked_histogram_one_launch_every_width(cuda_device, width):
    # the chunked tier's k (1-48, and past 512) in one launch: the whole
    # domain, windows, keys from 2^32 - 3 (all zeros), on a uniform, a
    # constant and a 90%-skewed column (many lanes of a warp on one bin or
    # one key's row), with and without a block_offset
    n = 4 * 256 * 32 + 5017
    dom = 1 << width
    uniform = _values(width, n, width + 500, cuda_device)
    columns = [uniform, torch.full_like(uniform, dom // 3),
               torch.where(uniform % 10 < 9, dom - 1, uniform)]
    cases = [(0, min(dom, 48)), (0, 1), (0, 2), (dom // 2, 40), (0, 4096), (max(dom - 3, 0), 8),
             ((1 << 32) - 3, 40), ((1 << 32) - 3, 1000)]
    for values in columns:
        tiles = unpack.pack_device_kernel(values, width).tiles
        for lo, k in cases:
            for bo in (0, 2):
                before = profiling.launch_count(scan._histogram_chunked_tiles)
                _same(scan._histogram_chunked_tiles(tiles, lo, k, width, n, bo),
                      scan._histogram_chunked_tiles_plain(tiles, lo, k, width, n, bo))
                assert profiling.launch_count(scan._histogram_chunked_tiles) == before + 1


@pytest.mark.parametrize("width", [13, 16, 20])
def test_domain_histogram_matches_plain(cuda_device, width):
    # ragged n (one value, a partial block, a partial tile), a value in
    # the last window, and a block_offset; a constant column (every value
    # a warp's hot value) and a skewed one (lanes of one value merged)
    dom = 1 << width
    big = 4 * 256 * 32 + 5017
    columns = [_values(width, n, width + n, cuda_device) for n in (1, 100, big)]
    columns.append(torch.full((big,), dom // 3, dtype=torch.int32, device=cuda_device))
    skewed = _values(width, big, width, cuda_device)
    columns.append(torch.where(skewed % 8 < 6, 5, skewed))
    for values in columns:
        n = values.shape[0]
        values[-1] = dom - 1
        tiles = unpack.pack_device_kernel(values, width).tiles
        expect = torch.bincount(values.to(torch.int64), minlength=dom)
        before = profiling.launch_count(scan._histogram_domain_tiles)
        _same(scan._histogram_domain_tiles(tiles, width, n), expect)
        assert profiling.launch_count(scan._histogram_domain_tiles) == before + 1
        for bo in (2, 1024):
            _same(scan._histogram_domain_tiles(tiles, width, n, bo),
                  scan._histogram_domain_tiles_plain(tiles, width, n, bo))
    with pytest.raises(ValueError, match="widths 13..20"):
        scan._histogram_domain_tiles(tiles, 12, 100)


def test_histogram_dispatch_launches_each_kernel(cuda_device):
    width, n = 9, 40_000
    vals = harness.synth_modk(n, 512, width, device=cuda_device)
    dev = port.pack_device_kernel(vals, width)
    expect = torch.bincount(vals.to(torch.int64), minlength=512)
    lo = _lo(100, cuda_device)
    cases = [((0, None), scan._histogram_span_tiles, expect),
             ((100, 40), scan._histogram_chunked_tiles, expect[100:140]),
             ((lo, 40), scan.histogram_tiles, expect[100:140])]
    for (lo_, k), fn, want in cases:
        before = profiling.launch_count(fn)
        torch.cuda.synchronize()
        if isinstance(lo_, torch.Tensor):  # runtime lo: nothing is read on the host
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = port.histogram_device(dev, lo_, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert profiling.launch_count(fn) == before + 1, fn.__name__
        _same(got, want)


def test_stats_on_the_card_equal_the_cpu(cuda_device):
    for width, n in ((9, 30_000), (13, 50_000), (20, 70_001)):
        host = np.random.default_rng(width).integers(0, 1 << width, n).astype(np.uint32)
        gdev = port.pack_device_kernel(torch.from_numpy(host.view(np.int32)).to(cuda_device), width)
        cdev = port.layout.pack_device(host, width, device="cpu")
        before = profiling.launch_count(scan._histogram_domain_tiles)
        counts = port.stats.histogram_full(gdev)
        assert profiling.launch_count(scan._histogram_domain_tiles) == before + (width > 12)
        np.testing.assert_array_equal(counts, np.bincount(host, minlength=1 << width))
        np.testing.assert_array_equal(counts, port.stats.histogram_full(cdev))
        assert port.stats.describe(gdev) == port.stats.describe(cdev)


@pytest.mark.parametrize("width", WIDTHS)
def test_zoned_kernel_matches_plain(cuda_device, width):
    n = 9 * 8 * 128 * 32 - 77  # b1 = 72, ragged tail
    values = _values(width, n, width + 170, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    lo_t = _keys([0, 1, dom - 1, 0xFFFFFFF0], cuda_device)
    hi_t = _keys([dom, 0, 2, 0], cuda_device)
    # live steps 0, 4 and the last (the ragged one), then a flag-0 repeat
    idx = torch.tensor([0, 4, 8, 8], dtype=torch.int32, device=cuda_device)
    flag = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=cuda_device)
    for tb in (8, 72):
        i, f = (idx, flag) if tb == 8 else (idx[:1], flag[:1])
        before = profiling.launch_count(port.zonemap.zoned_range_tiles)
        _same(port.zonemap.zoned_range_tiles(tiles, i, f, lo_t, hi_t, width, n, tb),
              port.zonemap.zoned_range_tiles_plain(tiles, i, f, lo_t, hi_t, width, n, tb))
        assert profiling.launch_count(port.zonemap.zoned_range_tiles) == before + 1


# (idx, flag, tb) on b1 = 72: unsorted steps, a step listed twice with flag
# 1, a flag-0 repeat and a step past the column; every step; one step of 72
# rows
ZONED_CASES = {"unsorted": ([8, 0, 4, 4, 0, 9], [1, 1, 1, 1, 0, 1], 8),
               "every step": (list(range(8, -1, -1)), [1] * 9, 8),
               "one step": ([0], [1], 72)}


@pytest.mark.parametrize("width", range(1, 32))
def test_zoned_kernel_writes_every_word(cuda_device, width):
    # the kernel launched directly on rows and counts filled with -1: every
    # word of the rows written, the counts zeroed by the C entry; then the
    # wrapper's count form (one launch, no row)
    n = 9 * 8 * 128 * 32 - 77  # b1 = 72, the ragged tail in the last step
    tiles = unpack.pack_device_kernel(_values(width, n, width + 300, cuda_device), width).tiles
    dom = 1 << width
    rng = np.random.default_rng(width)
    for k in (1, 4, scan.MAX_LAUNCH_KEYS) if width in (1, 9, 17, 31) else (1, 4):
        lo = rng.integers(0, dom, size=k)
        hi = lo + rng.integers(0, dom, size=k)
        lo[0], hi[0] = 0, dom  # the whole domain
        lows, highs = _keys(lo, cuda_device), _keys(hi % (1 << 32), cuda_device)
        for name, (idx, flag, tb) in ZONED_CASES.items():
            i, f = (torch.tensor(x, dtype=torch.int32, device=cuda_device) for x in (idx, flag))
            pbits, pcounts = port.zonemap.zoned_range_tiles_plain(tiles, i, f, lows, highs, width,
                                                                  n, tb)
            bits, counts = torch.full_like(pbits, -1), torch.full_like(pcounts, -1)
            _cuda.launch("sss_zoned_range_scan", cuda_device, tiles.data_ptr(), i.data_ptr(),
                         f.data_ptr(), len(idx), lows.data_ptr(), highs.data_ptr(), k,
                         bits.data_ptr(), counts.data_ptr(), 72 * 128, tb * 128, width, n)
            _same(bits, pbits)
            _same(counts, pcounts)
            before = profiling.launch_count(port.zonemap.zoned_range_tiles)
            none, counts = port.zonemap.zoned_range_tiles(tiles, i, f, lows, highs, width, n, tb,
                                                          False)
            assert none is None
            assert profiling.launch_count(port.zonemap.zoned_range_tiles) == before + 1
            _same(counts, pcounts)


def test_shift_verdict_is_one_launch(cuda_device):
    base, amounts = scan.canary_inputs(cuda_device)
    want = bool((scan.run_shift_canary(base, amounts)[0] == 0).all())
    torch.cuda.synchronize()
    scan._SHIFT_SEMANTICS.clear()
    before = (profiling.launch_count(scan.shift_verdict),
              profiling.launch_count(scan.run_shift_canary))
    allocated = torch.cuda.memory_stats(cuda_device).get("allocation.all.allocated", 0)
    got = scan.shift_saturates(cuda_device)
    # one launch of the verdict kernel, nothing elementwise, no tensor on the card
    assert torch.cuda.memory_stats(cuda_device).get("allocation.all.allocated", 0) == allocated
    assert (profiling.launch_count(scan.shift_verdict),
            profiling.launch_count(scan.run_shift_canary)) == (before[0] + 1, before[1])
    assert got == want == scan.shift_verdict_plain(cuda_device)
    assert scan.shift_saturates(cuda_device) == want  # cached
    assert profiling.launch_count(scan.shift_verdict) == before[0] + 1


def test_refused_zoned_and_verdict_launches_raise(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    lo = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    bits = torch.zeros((2, 8, 128), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    # (g, k, bits, nblocks, step_blocks, width): a negative list, no keys,
    # past the shared counters, a column or a step that is no whole block
    # row, widths 0 and 32
    for g, k, ptr, nblocks, step, width in (
            (-1, 1, bits.data_ptr(), 1024, 1024, 9), (1, 0, bits.data_ptr(), 1024, 1024, 9),
            (1, 1025, bits.data_ptr(), 1024, 1024, 9),
            (1, 1, bits.data_ptr(), 1000, 1024, 9), (1, 1, bits.data_ptr(), 1024, 64, 9),
            (1, 1, bits.data_ptr(), 1024, 1024, 0), (1, 1, bits.data_ptr(), 1024, 1024, 32)):
        with pytest.raises(RuntimeError, match="sss_zoned_range_scan"):
            _cuda.launch("sss_zoned_range_scan", cuda_device, tiles.data_ptr(), idx.data_ptr(),
                         idx.data_ptr(), g, lo.data_ptr(), lo.data_ptr(), k, ptr,
                         counts.data_ptr(), nblocks, step, width, 100)
    amounts = np.zeros(33, np.uint32)
    word = np.zeros(1, np.uint32)
    for count in (0, 33):
        with pytest.raises(RuntimeError, match="sss_shift_verdict"):
            _cuda.launch("sss_shift_verdict", cuda_device, amounts.ctypes.data, count,
                         word.ctypes.data)


def test_zone_maps_on_the_card_equal_the_cpu(cuda_device):
    zm_mod = port.zonemap
    width, n = 9, 9 * 8 * 128 * 32
    rng = np.random.default_rng(5)
    host = rng.integers(100, 200, size=n).astype(np.uint32)
    host[: 4096 * 8] = 7
    host[-4096 * 8:] = 7
    srt = np.sort(rng.integers(0, 512, size=n).astype(np.uint32))
    for vals in (host, srt):
        gdev = port.pack_device_kernel(torch.from_numpy(vals.view(np.int32)).to(cuda_device), width)
        cdev = port.layout.pack_device(vals, width, device="cpu")
        gz, cz = zm_mod.build_zonemap(gdev, zone_b1=8), zm_mod.build_zonemap(cdev, zone_b1=8)
        np.testing.assert_array_equal(gz.zmin, cz.zmin)
        np.testing.assert_array_equal(gz.zmax, cz.zmax)
        for lo, hi in ((7, 8), (100, 102), (150, 160), (300, 400)):
            for fn in (zm_mod.pruned_range_scan, zm_mod.zoned_range_scan):
                gbits, gcount = fn(gdev, gz, lo, hi)
                cbits, ccount = fn(cdev, cz, lo, hi)
                _same(gbits.cpu(), cbits)
                mask = (vals >= lo) & (vals < hi)
                assert int(gcount) == int(ccount) == int(mask.sum()), (fn.__name__, lo, hi)
    # the end clusters of `host` take the zoned kernel on 2 of 9 steps
    gdev = port.pack_device_kernel(torch.from_numpy(host.view(np.int32)).to(cuda_device), width)
    gz = zm_mod.build_zonemap(gdev, zone_b1=8)
    before = profiling.launch_count(zm_mod.zoned_range_tiles)
    bits, count = zm_mod.zoned_eq_scan(gdev, gz, 7, tb=8)
    assert profiling.launch_count(zm_mod.zoned_range_tiles) == before + 1
    _same(bits, bitvector.from_bool(torch.from_numpy(host == 7).to(cuda_device)))


def test_query_with_zone_maps_on_the_card(cuda_device):
    width, n = 9, 40_000
    rng = np.random.default_rng(7)
    a_vals = np.sort(rng.integers(0, 1 << width, size=n).astype(np.uint32))
    b_vals = rng.integers(0, 1 << width, size=n).astype(np.uint32)
    a, b = (port.pack_device_kernel(torch.from_numpy(v.view(np.int32)).to(cuda_device), width)
            for v in (a_vals, b_vals))
    zmaps = {id(a): port.zonemap.build_zonemap(a, zone_b1=8)}
    expr = query.And(query.Range(a, 100, 120), query.Not(query.Eq(b, 7)))
    fns = (scan.range_scan_tiles, conj.conj_range_scan_tiles)
    before = [profiling.launch_count(f) for f in fns]
    bits, count = query.evaluate(expr, zonemaps=zmaps)
    # the mapped group one conjunction over its span, the NOT's Eq one over the column
    assert [profiling.launch_count(f) - b for f, b in zip(fns, before)] == [0, 2]
    plain_bits, plain_count = query.evaluate(expr)
    _same(bits, plain_bits)
    assert int(count) == int(plain_count) == int(
        ((a_vals >= 100) & (a_vals < 120) & (b_vals != 7)).sum())


def test_pruned_conjunction_and_masked_sum_on_the_card(cuda_device):
    width, n = 12, 3_000_017
    rng = np.random.default_rng(8)
    vals = {"date": np.sort(rng.integers(0, 2406, n)), "qty": rng.integers(1, 51, n),
            "disc": rng.integers(0, 11, n), "price": rng.integers(90000, 1 << 24, n)}
    widths = {"date": width, "qty": 6, "disc": 4, "price": 24}
    cols = {k: port.pack_device_kernel(torch.from_numpy(v.astype(np.int32)).to(cuda_device),
                                       widths[k]) for k, v in vals.items()}
    zmaps = {id(cols["date"]): port.zonemap.build_zonemap(cols["date"], zone_b1=64)}
    for d0, d1 in ((0, 2406), (365, 730), (700, 731), (2400, 2406), (3000, 3100)):
        expr = query.And(query.Range(cols["date"], d0, d1), query.Range(cols["qty"], 1, 25),
                         query.Eq(cols["disc"], 4))
        before = profiling.counters()
        bits, count, rows = query.evaluate_pruned(expr, zmaps)
        total, agg_count = aggregate.masked_aggregate_device(cols["price"], bits, rows=rows)
        after = profiling.counters()
        rose = {k: after.get(k, 0) - before.get(k, 0) for k in (
            "launches.conj_range_scan_tiles", "launches.masked_aggregate_tiles",
            "query.count.popcount", "zonemap.pruned_empty")}
        empty = d0 >= 2406
        assert rose == {"launches.conj_range_scan_tiles": int(not empty),
                        "launches.masked_aggregate_tiles": int(not empty),
                        "query.count.popcount": 0, "zonemap.pruned_empty": int(empty)}
        want = ((vals["date"] >= d0) & (vals["date"] < d1) & (vals["qty"] < 25)
                & (vals["disc"] == 4))
        _same(bits, bitvector.from_bool(torch.from_numpy(want).to(cuda_device)))
        assert int(count) == int(agg_count) == int(want.sum())
        assert int(total) == int(vals["price"][want].sum())


def test_refused_histogram_and_zoned_launches_raise(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    lo = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(4097, dtype=torch.int64, device=cuda_device)
    with pytest.raises(RuntimeError, match="sss_histogram"):
        # 4097 bins: more than the kernel's shared counters hold
        _cuda.launch("sss_histogram", cuda_device, tiles.data_ptr(), lo.data_ptr(), 4097,
                     counts.data_ptr(), 8 * 128, 9, 100, 0)
    with pytest.raises(RuntimeError, match="sss_histogram_span"):
        _cuda.launch("sss_histogram_span", cuda_device, tiles.data_ptr(), 0, 4097,
                     counts.data_ptr(), 8 * 128, 9, 100, 0)
    with pytest.raises(RuntimeError, match="sss_histogram_domain"):
        # width 12: a domain of one window
        _cuda.launch("sss_histogram_domain", cuda_device, tiles.data_ptr(), counts.data_ptr(),
                     8 * 128, 12, 100, 0)
    for k, width in ((4097, 4), (1025, 4), (0, 4), (8, 9), (8, 32), (8, 0)):
        with pytest.raises(RuntimeError, match="sss_histogram_fold"):
            # more keys than its shared counters; no keys; no such width
            _cuda.launch("sss_histogram_fold", cuda_device, tiles.data_ptr(), 0, k,
                         counts.data_ptr(), 8 * 128, width, 100, 0)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    bits = torch.zeros((1, 8, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="sss_zoned_range_scan"):
        # a step of 0 blocks
        _cuda.launch("sss_zoned_range_scan", cuda_device, tiles.data_ptr(), idx.data_ptr(),
                     idx.data_ptr(), 1, lo.data_ptr(), lo.data_ptr(), 1, bits.data_ptr(),
                     counts.data_ptr(), 8 * 128, 0, 9, 100)


LINEAR_KS = (4, 8, 12, 16, 20, 24, 28, 32, 64, 128)


def _rand_words(shape, seed, device):
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


@pytest.mark.parametrize("k", [1, 3, 4, 6, 8, 12, 16, 24, 33, 64, 1024])
def test_interleave_kernel_matches_plain(cuda_device, k):
    for w in (1, 257, 9000):
        bits = _rand_words((k, w), k + w, cuda_device)
        for nwords in (w * k, -(-(4 * w - 3) * k // 4)):
            before = profiling.launch_count(linear.interleave_words)
            _same(linear.interleave_words(bits, nwords), linear.interleave_words_plain(bits, nwords))
            assert profiling.launch_count(linear.interleave_words) == before + 1
        wide = torch.zeros((k, w + 77), dtype=torch.int32, device=cuda_device)
        wide[:, :w] = bits
        _same(linear.interleave_words(wide[:, :w], w * k), linear.interleave_words_plain(bits, w * k))


@pytest.mark.parametrize("m,g", [(4, 2), (3, 2), (8, 2), (4, 128), (5, 3)])
def test_interleave_streams_kernel_matches_plain(cuda_device, m, g):
    for M in (1, 1000, 4096):
        streams = _rand_words((m, M), m * g + M, cuda_device)
        for nwords in (m * M - 5, m * M, m * M + 37):
            if nwords > 0:
                _same(linear.interleave_streams_words(streams, g, nwords),
                      linear.interleave_streams_words_plain(streams, g, nwords))


@pytest.mark.parametrize("width", WIDTHS)
def test_fused_linear_kernels_match_plain(cuda_device, width):
    values = _values(width, N, width + 200, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    rng = np.random.default_rng(width)
    for k in LINEAR_KS:
        keys = rng.integers(0, dom, size=k).astype(np.uint32)
        keys[1], keys[2], keys[3] = keys[0], min(dom, 0xFFFFFFFF), 0xFFFFFFFF
        kt = _keys(keys, cuda_device)
        for bo in (0, 2):
            for lo in (0, max(dom - 5, 0)):
                _same(scan._interval_linear_tiles_impl(tiles, lo, k, width, N, bo),
                      scan._interval_linear_tiles_plain(tiles, lo, k, width, N, bo))
            _same(scan._static_linear_tiles_impl(tiles, keys, width, N, bo),
                  scan._static_linear_tiles_plain(tiles, keys, width, N, bo))
            _same(scan._bitsliced_linear_tiles_impl(tiles, kt, width, N, bo),
                  scan._bitsliced_linear_tiles_plain(tiles, kt, width, N, bo))


FUSED_KS = tuple(k for k in range(4, 129, 4) if k <= 64 or k % 8 == 0)


@pytest.mark.parametrize("width", range(1, 32))
def test_static_linear_fold_every_fused_k(cuda_device, width):
    # the host keys by value at every fused k: duplicates, a key at 2^W,
    # 0xFFFFFFFF, under a block_offset; counts against their own bits
    values = _values(width, N, width + 400, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    rng = np.random.default_rng(width + 400)
    for k in FUSED_KS:
        keys = rng.integers(0, dom, size=k).astype(np.uint32)
        keys[1], keys[2], keys[-1] = keys[0], min(dom, 0xFFFFFFFF), 0xFFFFFFFF
        for bo in (0, 2):
            before = profiling.launch_count(scan._static_linear_tiles_impl)
            got = scan._static_linear_tiles_impl(tiles, keys, width, N, bo)
            assert profiling.launch_count(scan._static_linear_tiles_impl) == before + 1
            _same(got, scan._static_linear_tiles_plain(tiles, keys, width, N, bo))


@pytest.mark.parametrize("width", range(1, 32))
def test_runtime_linear_fold_every_fused_k(cuda_device, width):
    # the keys in device memory at every fused k, through the static fold's
    # staged masks: duplicates, a key at 2^W, 0xFFFFFFFF, under a
    # block_offset
    values = _values(width, N, width + 700, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    dom = 1 << width
    rng = np.random.default_rng(width + 700)
    for k in FUSED_KS:
        keys = rng.integers(0, dom, size=k).astype(np.uint32)
        keys[1], keys[2], keys[-1] = keys[0], min(dom, 0xFFFFFFFF), 0xFFFFFFFF
        kt = _keys(keys, cuda_device)
        for bo in (0, 2):
            before = profiling.launch_count(scan._bitsliced_linear_tiles_impl)
            got = scan._bitsliced_linear_tiles_impl(tiles, kt, width, N, bo)
            assert profiling.launch_count(scan._bitsliced_linear_tiles_impl) == before + 1
            _same(got, scan._bitsliced_linear_tiles_plain(tiles, kt, width, N, bo))
            _same(got, scan._static_linear_tiles_impl(tiles, keys, width, N, bo))


def test_linear_dispatch_launches_each_kernel(cuda_device):
    width, n = 9, 300_001
    vals = harness.synth_modk(n, 512, width, device=cuda_device)
    col = port.layout.pack(vals, width)
    dev = port.layout.to_device(col)
    spread = [3, 70, 141, 200, 262, 333, 400, 511]
    cases = [  # keys, on the card, the wrapper that must launch once
        (list(range(8)), False, scan._interval_linear_tiles_impl),
        (list(range(100, 164)), False, scan._interval_linear_tiles_impl),
        (spread, False, scan._static_linear_tiles_impl),
        (spread * 3, False, scan._static_linear_tiles_impl),
        (spread, True, scan._bitsliced_linear_tiles_impl),
        (spread * 8, True, scan._bitsliced_linear_tiles_impl),
        (list(range(132)), False, linear.interleave_words),
        (list(range(6)), False, linear.interleave_words),
        (spread[:6], True, linear.interleave_words),
    ]
    for keys, on_card, fn in cases:
        want = oracle.shared_scan_linear(col, keys)
        kt = _keys(keys, cuda_device) if on_card else keys
        before = profiling.launch_count(fn)
        torch.cuda.synchronize()
        if on_card:  # runtime keys: nothing is read on the host
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = port.shared_scan_linear_device(dev, kt)
            words = scan.shared_scan_linear_words_device(dev, kt) if len(keys) % 4 == 0 else None
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert profiling.launch_count(fn) == before + (1 if words is None else 2), \
            (len(keys), fn.__name__)
        _same(got, want)
        if words is not None:
            _same(words.view(torch.uint8), want)


def test_refused_linear_launches_raise(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    out = torch.zeros(8 * 128 * 132, dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(132, dtype=torch.int64, device=cuda_device)
    for k in (3, 132):  # k % 4 != 0, and k past the stage
        with pytest.raises(RuntimeError, match="sss_interval_scan_linear"):
            _cuda.launch("sss_interval_scan_linear", cuda_device, tiles.data_ptr(), 0, k,
                         out.data_ptr(), counts.data_ptr(), 8 * 128, 9, 100, 0, 1)
        with pytest.raises(RuntimeError, match="sss_bitsliced_scan_linear"):
            _cuda.launch("sss_bitsliced_scan_linear", cuda_device, tiles.data_ptr(),
                         out.data_ptr(), k, out.data_ptr(), counts.data_ptr(), 8 * 128, 9, 100, 0)
    for width in (0, 32):  # no fold body of that width
        with pytest.raises(RuntimeError, match="sss_bitsliced_scan_linear"):
            _cuda.launch("sss_bitsliced_scan_linear", cuda_device, tiles.data_ptr(),
                         out.data_ptr(), 8, out.data_ptr(), counts.data_ptr(), 8 * 128, width,
                         100, 0)
    keys = np.arange(132, dtype=np.uint32)
    for k in (3, 132):
        with pytest.raises(RuntimeError, match="sss_bitsliced_static_scan_linear"):
            _cuda.launch("sss_bitsliced_static_scan_linear", cuda_device, tiles.data_ptr(),
                         keys.ctypes.data, k, out.data_ptr(), counts.data_ptr(), 8 * 128, 9, 100, 0)
    with pytest.raises(RuntimeError, match="sss_interleave"):
        # a granule of 2 bytes
        _cuda.launch("sss_interleave", cuda_device, out.data_ptr(), 512, 512, 2, 2, 4,
                     out.data_ptr(), 64)
    with pytest.raises(ValueError, match="shared memory"):
        linear.interleave_streams_words(torch.zeros((64, 8192), dtype=torch.int32,
                                                    device=cuda_device), 1024, 100)


STAGE = harness.COPY_STAGE_BYTES


@pytest.mark.parametrize("nbytes", [1, 15, 16, 17, 4097, 32768 + 5, 1_000_003, STAGE - 16,
                                    STAGE + 16, 5 * STAGE + 7, 3072 * STAGE + 7])
def test_copy_kernel_matches_plain(cuda_device, nbytes):
    rng = np.random.default_rng(nbytes)
    src = torch.from_numpy(rng.integers(0, 256, size=nbytes, dtype=np.uint8)).to(cuda_device)
    dst = torch.zeros_like(src)
    before = profiling.launch_count(harness.memcpy)
    harness.memcpy(src, dst)
    assert profiling.launch_count(harness.memcpy) == before + 1
    _same(dst, harness.memcpy_plain(src, torch.zeros_like(src)))


def test_copy_kernel_refuses_misaligned_and_overlapping(cuda_device):
    buf = torch.zeros(4096, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        harness.memcpy(buf[1:1025], buf[2048:3072])
    with pytest.raises(ValueError, match="overlap"):
        harness.memcpy(buf[:1024], buf[512:1536])
    with pytest.raises(RuntimeError, match="sss_copy"):
        _cuda.launch("sss_copy", cuda_device, buf.data_ptr() + 4, buf.data_ptr() + 2048, 64)


@pytest.mark.parametrize("width", [1, 2, 9, 12, 13, 17, 31])
def test_chunked_and_dynamic_kernels_match_plain(cuda_device, width):
    # widths 12 and 13: the last on the kernels' direct tables, the first on
    # their search; k around one chunk and one group of 64 rows; a chunk of
    # equal keys; a key repeated across the chunk boundary, across groups
    # of rows (k = 130) and across the dynamic kernel's launch boundary (k =
    # 1025); keys all past the domain
    dom = 1 << width
    values = _values(width, N, width + 90, cuda_device)
    tiles = unpack.pack_device_kernel(values, width).tiles
    rng = np.random.default_rng(width)
    c, launch = scan.CHUNK_KEYS, scan.MAX_LAUNCH_KEYS
    key_sets = []
    for k in (1, 8, 9, 17, 33, 40, c - 1, c, c + 1, 130, launch + 1):
        keys = rng.integers(0, dom, size=k).astype(np.int64)
        keys[: min(k, 4)] = [0, 0xFFFFFFFF, dom, int(values[3])][: min(k, 4)]
        if k > c:
            keys[c - 1] = keys[c] = keys[3]
            keys[k - 1] = keys[5]
        if k > launch:
            keys[launch - 1] = keys[launch] = int(values[9])
        key_sets.append(keys)
    key_sets.append(np.full(c, int(values[7])))
    key_sets.append(np.array([dom, 0xFFFFFFFF, dom + 1, 0xFFFFFFFF]))
    for keys in key_sets:
        kt = _keys(keys, cuda_device)
        for bo in (0, 2):
            _same(scan.shared_scan_chunked_tiles(tiles, kt, width, N, bo),
                  scan.shared_scan_chunked_tiles_plain(tiles, kt, width, N, bo))
            _same(scan.shared_scan_dynamic_tiles(tiles, kt, width, N, bo),
                  scan.shared_scan_dynamic_tiles_plain(tiles, kt, width, N, bo))


def test_chunked_and_dynamic_kernels_past_1024_keys(cuda_device):
    # the dynamic entry point launches keys in chunks of 1024, each counted;
    # the chunked kernel takes any k in one launch
    width = 11
    tiles = unpack.pack_device_kernel(_values(width, N, 13, cuda_device), width).tiles
    kt = _keys(((np.arange(1500) * 7) % 2100).tolist() + [0xFFFFFFFF], cuda_device)
    ref = scan.shared_scan_tiles_plain(tiles, kt, width, N)
    for fn, launches in ((scan.shared_scan_chunked_tiles, 1), (scan.shared_scan_dynamic_tiles, 2)):
        before = profiling.launch_count(fn)
        _same(fn(tiles, kt, width, N), ref)
        assert profiling.launch_count(fn) == before + launches


def test_chunked_and_dynamic_keys_never_reach_the_host(cuda_device):
    width, n = 9, 32_000
    dev = port.pack_device_kernel(harness.synth_modk(n, 512, width, device=cuda_device), width)
    kt = torch.arange(40, dtype=torch.int32, device=cuda_device) * 11
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [fn(dev.tiles, kt, width, n) for fn in (scan.shared_scan_chunked_tiles,
                                                       scan.shared_scan_dynamic_tiles)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    expect = [(n - 1 - key) // 512 + 1 if key < 512 else 0 for key in kt.tolist()]
    for _, counts in outs:
        assert counts.tolist() == expect
