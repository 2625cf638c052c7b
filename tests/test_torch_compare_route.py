"""The compare tier's route to the bit-sliced tier's kernels, on the CPU.

``shared_scan_tiles`` launches, for the k where ``_compare_fold_wins``
says so, the bit-sliced tier's launch on the same key tensor (the plane
fold ``sss_bitsliced_static_fold``, or the dynamic scan's lookup where
``_runtime_lookup_wins``).  That is only sound if the three functions
agree to the bit on every key: keys past the domain, 0xFFFFFFFF, slots
that straddle two words, key 0 over the zero padding of a ragged n, a
block_offset.  Their plain versions repeat the kernels' algorithms, so
they are held to each other here; the wrapper's launches are recorded
with the CUDA calls replaced.  No JAX: the plain compare is held against
the JAX package in ``test_torch_scan.py``.
"""
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu_torch.ops import _cuda, scan, unpack

torch.set_num_threads(1)

ROUTE_WIDTHS = (1, 5, 9, 12, 17, 20, 31)
N = 3 * 128 * 32 - 11  # three blocks of lanes, the last value slots padding


def _edge_keys(width: int, values: np.ndarray, rng) -> np.ndarray:
    """Keys of the column, key 0, a duplicate, and keys no value holds."""
    drawn = values[rng.integers(0, values.shape[0], size=6)].astype(np.uint64).tolist()
    edges = [0, drawn[0], 1 << width, 1 << 31, 0xFFFFFFFF, (1 << width) - 1]
    return np.asarray(drawn + edges, dtype=np.uint64).astype(np.uint32)


def _column(width: int, seed: int):
    rng = np.random.default_rng(seed)
    # values 0 and the domain's top are common, so the edge keys hit
    values = rng.integers(0, 1 << width, size=N).astype(np.uint32)
    values[rng.integers(0, N, size=N // 8)] = 0
    values[rng.integers(0, N, size=N // 8)] = (1 << width) - 1
    tiles = unpack.pack_device_kernel(torch.from_numpy(values.view(np.int32)), width).tiles
    return values, tiles, rng


@pytest.mark.parametrize("block_offset", (0, 3))
@pytest.mark.parametrize("width", ROUTE_WIDTHS)
def test_compare_and_route_plain_versions_agree(width, block_offset):
    values, tiles, rng = _column(width, width)
    keys = _edge_keys(width, values, rng)
    kt = torch.from_numpy(keys.view(np.int32).copy())
    want = scan.shared_scan_tiles_plain(tiles, kt, width, N, block_offset)
    for fn in (scan.shared_scan_bitsliced_tiles_plain, scan.shared_scan_dynamic_tiles_plain):
        got = fn(tiles, kt, width, N, block_offset)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # each row is the equality of value and key, padding cleared
    real = np.zeros(tiles.shape[1] * 128 * 32, bool)
    real[: max(N - 32 * block_offset, 0)] = True
    flat = np.zeros(real.shape[0], np.uint32)
    flat[:N] = values
    counts = [int(((flat == key) & real).sum()) for key in keys]
    assert want[1].tolist() == counts


def test_compare_fold_rule_takes_only_measured_wins():
    table = scan._COMPARE_FOLD_KS
    assert set(table) <= set(scan._COMPARE_SWEEP_WIDTHS)
    assert all(set(ks) <= set(scan._COMPARE_SWEEP_KS) for ks in table.values())
    for width in scan._COMPARE_SWEEP_WIDTHS:
        for k in scan._COMPARE_SWEEP_KS:
            assert scan._compare_fold_wins(width, k) == (k in table.get(width, ())), (width, k)
    for width in range(1, 32):
        for k in range(1, scan.MAX_LAUNCH_KEYS + 1):
            if not scan._compare_fold_wins(width, k):
                continue
            ws = scan._around(scan._COMPARE_SWEEP_WIDTHS, width)
            ks = scan._around(scan._COMPARE_SWEEP_KS, k)
            assert all(m in table[w] for w in ws for m in ks), (width, k)


def test_compare_fold_rule_outside_the_sweep():
    assert not scan._compare_fold_wins(9, 0)
    assert not scan._compare_fold_wins(0, 8)
    assert not scan._compare_fold_wins(32, 8)
    assert scan._around((1, 4, 16), 4) == (4, 4)
    assert scan._around((1, 4, 16), 5) == (4, 16)
    assert scan._around((1, 4, 16), 17) is None


@pytest.mark.parametrize("width", ROUTE_WIDTHS)
def test_compare_wrapper_launches_the_kernel_the_rule_names(width, monkeypatch):
    # the CUDA branch with the launches recorded: one a group of 1024 keys,
    # sss_shared_scan where the rule keeps the compare kernel, else the
    # bit-sliced tier's kernel, each counted by its own wrapper
    calls = []
    monkeypatch.setattr(_cuda, "kernel_device", lambda *ts: torch.device("cpu"))
    monkeypatch.setattr(_cuda, "launch", lambda fn, device, *args: calls.append((fn, args[2])))
    tiles = torch.zeros((width, 2, 128), dtype=torch.int32)
    fns = (scan.shared_scan_tiles, scan.shared_scan_bitsliced_tiles,
           scan.shared_scan_dynamic_tiles)
    for k in (1, 2, 4, 5, 8, 16, 64, 300, 1024, 1025, 2100):
        calls.clear()
        before = [fn.launches for fn in fns]
        bits, counts = scan.shared_scan_tiles(tiles, torch.zeros(k, dtype=torch.int32), width,
                                              100)
        assert bits.shape == (k, 2, 128) and counts.shape == (k,)
        want, launches = [], [0, 0, 0]
        for g0 in range(0, k, scan.MAX_LAUNCH_KEYS):
            rows = min(k - g0, scan.MAX_LAUNCH_KEYS)
            if not scan._compare_fold_wins(width, rows):
                want.append(("sss_shared_scan", rows))
                launches[0] += 1
            elif scan._runtime_lookup_wins(width, rows):
                want.append(("sss_shared_scan_dynamic", rows))
                launches[2] += 1
            else:
                want.append(("sss_bitsliced_static_fold", rows))
                launches[1] += 1
        assert calls == want, (width, k)
        assert [fn.launches - b for fn, b in zip(fns, before)] == launches
