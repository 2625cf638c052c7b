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
from shared_simd_scan_tpu_torch.bench import harness
from shared_simd_scan_tpu_torch.ops import _cuda, scan, unpack

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
    # the C entry point launches keys in chunks of 1024
    width = 11
    tiles = unpack.pack_device_kernel(_values(width, N, 11, cuda_device), width).tiles
    kt = _keys((np.arange(1500) * 7) % 2048, cuda_device)
    _same(scan.shared_scan_tiles(tiles, kt, width, N),
          scan.shared_scan_tiles_plain(tiles, kt, width, N))


def test_shift_canary_matches_plain(cuda_device):
    base, amounts = scan.canary_inputs(cuda_device)
    ptx, _ = scan.run_shift_canary(base, amounts)
    _same(ptx, scan.shift_canary_plain(base, amounts))
    assert scan.shift_saturates(cuda_device)


def test_slice_kernels_match_cpu_plain_path(cuda_device):
    width, n = 9, 32_000
    vals = harness.synth_modk(n, 8, width, device=cuda_device)
    counts_before = {f: f.launches for f in (unpack.pack_tiles, unpack.unpack_tiles,
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
        assert f.launches > before, f.__name__
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
    # the runtime kernel chunks keys in C; the static and windowed wrappers
    # launch one program or plan per 1024 rows
    width = 11
    tiles = unpack.pack_device_kernel(_values(width, N, 12, cuda_device), width).tiles
    keys = ((np.arange(1500) * 7) % 2100).tolist()
    kt = _keys(keys, cuda_device)
    ref = scan.shared_scan_tiles_plain(tiles, kt, width, N)
    _same(scan.shared_scan_bitsliced_tiles(tiles, kt, width, N), ref)
    _same(scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, N), ref)
    _same(scan.windowed_scan_tiles(tiles, keys, width, N), ref)


def test_static_dag_past_48kb_of_shared_memory(cuda_device):
    width = 31
    tiles = unpack.pack_device_kernel(_values(width, N, 31, cuda_device), width).tiles
    keys = np.random.default_rng(1).integers(0, 1 << 31, size=32).tolist()
    _, slots = scan._static_program(width, tuple(keys))
    assert slots * scan._static_threads(slots) * 4 > 48 * 1024
    _same(scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, N),
          scan.shared_scan_bitsliced_static_tiles_plain(tiles, keys, width, N))


def test_refused_static_launch_raises(cuda_device):
    width, n = 9, 1000
    tiles = torch.zeros((width, 8, 128), dtype=torch.int32, device=cuda_device)
    prog, _ = scan._static_program_on(width, (3, 70), cuda_device)
    bits = torch.empty((2, 8, 128), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(RuntimeError, match="sss_bitsliced_static_scan"):
        # 4096 slots x 128 threads: 2 MB of shared memory, more than a CTA has
        _cuda.launch("sss_bitsliced_static_scan", cuda_device, tiles.data_ptr(),
                     prog.data_ptr(), prog.shape[0], 2, bits.data_ptr(), counts.data_ptr(),
                     8 * 128, width, n, 0, 128, 4096)


def test_dispatcher_launches_each_tier(cuda_device):
    width, n = 9, 32_000
    vals = harness.synth_modk(n, 512, width, device=cuda_device)
    dev = port.pack_device_kernel(vals, width)
    spread8 = [3, 70, 141, 200, 262, 333, 400, 511]
    cases = [
        (list(range(8)), "interval", scan.interval_scan_tiles),
        ([0, 2, 4, 6], "windowed", scan.windowed_scan_tiles),
        (spread8, "bitsliced_static", scan.shared_scan_bitsliced_static_tiles),
        ([5, 300], "compare", scan.shared_scan_tiles),
        (torch.tensor(spread8, dtype=torch.int32, device=cuda_device), None,
         scan.shared_scan_bitsliced_tiles),
        (torch.tensor([5, 300], dtype=torch.int32, device=cuda_device), None,
         scan.shared_scan_tiles),
    ]
    for keys, tier, fn in cases:
        if tier is not None:
            assert scan.pick_concrete_tier(width, keys)[0] == tier
        before = fn.launches
        bits, counts = port.shared_scan_device(dev, keys)
        assert fn.launches == before + 1, (keys, fn.__name__)
        host = scan._host_keys(keys)
        assert counts.tolist() == [int((vals == int(key)).sum()) for key in host.view(np.int32)]
        assert harness.check_shared_scan(dev, keys, vals)


def test_cuda_keys_never_reach_the_host(cuda_device, monkeypatch):
    width, n = 9, 32_000
    dev = port.pack_device_kernel(_values(width, n, 5, cuda_device), width)
    keys = torch.tensor([3, 70, 141, 200, 262, 333, 400, 511], dtype=torch.int32,
                        device=cuda_device)
    expect = port.shared_scan_device(dev, keys.cpu())
    before = scan.shared_scan_bitsliced_tiles.launches

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
    assert scan.shared_scan_bitsliced_tiles.launches == before + 1
    _same(bits, expect[0])
    _same(counts, expect[1])
    _same(bits1, expect[0][3])
    _same(count1, expect[1][3])


def test_wrappers_refuse_mixed_devices(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        scan.shared_scan_tiles(tiles, torch.zeros(1, dtype=torch.int32), 9, 100)


def test_build_is_cached(cuda_device):
    path = _cuda.build()
    assert path == _cuda.library_path() and path.exists()
    assert _cuda.build() == path
