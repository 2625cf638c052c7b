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


def test_wrappers_refuse_mixed_devices(cuda_device):
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        scan.shared_scan_tiles(tiles, torch.zeros(1, dtype=torch.int32), 9, 100)


def test_build_is_cached(cuda_device):
    path = _cuda.build()
    assert path == _cuda.library_path() and path.exists()
    assert _cuda.build() == path
