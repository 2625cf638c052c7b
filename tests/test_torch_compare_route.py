"""The shared scan's route, on the CPU.

``pick_route`` names the kernel of each launch of ``shared_scan_tiles``
from the committed H100 tables: the compare kernel (``sss_shared_scan``)
where ``_compare_fold_wins`` says no, else the plane fold
(``sss_bitsliced_static_fold``), or the dynamic scan's lookup where
``_runtime_lookup_wins``, and for host keys there the window lookup
(``sss_windowed_lookup``) where ``_WINDOW_LOOKUP_KS`` says so.  That is
only sound if the kernels agree
to the bit on every key: keys past the domain, 0xFFFFFFFF, slots that
straddle two words, key 0 over the zero padding of a ragged n, a
block_offset.  Their plain versions repeat the kernels' algorithms, so
they are held to each other here; the wrapper's launches are recorded
with the CUDA calls replaced.  Host keys, CPU-tensor keys and the sharded
scan take the same route, and the benchmark's shared-scan cells draw key
sets that land on the interval kernel and the fold.  No JAX: the plain
compare is held against the JAX package in ``test_torch_scan.py``.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from scanbench.generators import shared_scan as cell_keys
from shared_simd_scan_tpu_torch import layout
from shared_simd_scan_tpu_torch.ops import _cuda, scan, unpack
from shared_simd_scan_tpu_torch.parallel import dist
from shared_simd_scan_tpu_torch.utils import profiling

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
    # on the kernel pick_route names, each counted by its own wrapper
    calls = []
    monkeypatch.setattr(_cuda, "kernel_device", lambda *ts: torch.device("cpu"))
    monkeypatch.setattr(_cuda, "launch", lambda fn, device, *args: calls.append((fn, args[2])))
    tiles = torch.zeros((width, 2, 128), dtype=torch.int32)
    fns = (scan.shared_scan_tiles, scan.shared_scan_bitsliced_tiles,
           scan.shared_scan_dynamic_tiles)
    kernels = {"compare": "sss_shared_scan", "fold": "sss_bitsliced_static_fold",
               "lookup": "sss_shared_scan_dynamic"}
    for k in (1, 2, 4, 5, 8, 16, 64, 300, 1024, 1025, 2100):
        calls.clear()
        before = [profiling.launch_count(fn) for fn in fns]
        bits, counts = scan.shared_scan_tiles(tiles, torch.zeros(k, dtype=torch.int32), width,
                                              100)
        assert bits.shape == (k, 2, 128) and counts.shape == (k,)
        want, launches = [], [0, 0, 0]
        for g0 in range(0, k, scan.MAX_LAUNCH_KEYS):
            rows = min(k - g0, scan.MAX_LAUNCH_KEYS)
            route = scan.pick_route(width, rows)
            want.append((kernels[route], rows))
            launches[list(kernels).index(route)] += 1
        assert calls == want, (width, k)
        assert [profiling.launch_count(fn) - b for fn, b in zip(fns, before)] == launches


@pytest.mark.parametrize("width", scan._COMPARE_SWEEP_WIDTHS)
def test_route_reads_the_committed_tables(width):
    # at every swept width: the compare kernel exactly where the compare
    # sweep measured no win for the fold, past it the lookup exactly where
    # the runtime sweep measured one, and for host keys the window lookup
    # there exactly where the windowed sweep did; between the points, the
    # rules
    fold_ks = scan._COMPARE_FOLD_KS.get(width, ())
    lookup_ks = scan._RUNTIME_LOOKUP_KS.get(width, ())
    for k in scan._COMPARE_SWEEP_KS:
        assert (scan.pick_route(width, k) == "compare") == (k not in fold_ks), k
    for k in scan._RUNTIME_SWEEP_KS:
        if scan.pick_route(width, k) != "compare":
            assert (scan.pick_route(width, k) == "lookup") == (k in lookup_ks), k
    if width in scan._WINDOW_SWEEP_WIDTHS:
        for k in scan._WINDOW_SWEEP_KS:
            assert (scan.pick_route(width, k, True) == "window") == \
                (k in scan._WINDOW_LOOKUP_KS[width]), k
    for k in range(1, scan.MAX_LAUNCH_KEYS + 1):
        want = ("compare" if not scan._compare_fold_wins(width, k) else
                "lookup" if scan._runtime_lookup_wins(width, k) else "fold")
        assert scan.pick_route(width, k) == want, k
        window = want == "lookup" and scan._won_around(
            scan._WINDOW_SWEEP_WIDTHS, scan._WINDOW_SWEEP_KS, scan._WINDOW_LOOKUP_KS, width, k)
        assert scan.pick_route(width, k, True) == ("window" if window else want), k


def _tiers(fn) -> dict:
    """The ``tier.*`` counters that ``fn()`` moves, and by how much."""
    before = {k: v for k, v in profiling.counters().items() if k.startswith("tier.")}
    out = fn()
    after = {k: v for k, v in profiling.counters().items() if k.startswith("tier.")}
    moved = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return moved, out


@pytest.mark.parametrize("width", (1, 9, 12, 17, 31))
def test_host_cpu_and_sharded_keys_take_one_route(width):
    # drawn sets of 3, 300 and 1030 keys (launches of 1024 and 6): the
    # compare kernel, the fold, the lookup or the window lookup by width
    # and k, the same decisions for a list, a CPU tensor and each shard of
    # a sharded column, with the same bits and counts
    values, tiles, rng = _column(width, width + 40)
    dev = layout.DeviceColumn(tiles=tiles, n=N, width=width)
    mesh = dist.make_mesh(["cpu"] * 2)
    sharded = dist.shard_column(dev, mesh)
    for k in (3, 300, 1030):
        keys = rng.integers(0, 2 << width, size=k).astype(np.uint32)
        keys[:2] = values[7]  # a duplicate: never a consecutive run
        routes = {}
        for g0 in range(0, k, scan.MAX_LAUNCH_KEYS):
            tier = "tier." + scan.pick_route(width, min(k - g0, scan.MAX_LAUNCH_KEYS), True)
            routes[tier] = routes.get(tier, 0) + 1
        forms = {"list": lambda: scan.shared_scan_device(dev, keys.tolist()),
                 "tensor": lambda: scan.shared_scan_device(
                     dev, torch.from_numpy(keys.view(np.int32).copy())),
                 "sharded": lambda: dist.sharded_shared_scan(sharded, keys, mesh)}
        results = {}
        for name, fn in forms.items():
            moved, results[name] = _tiers(fn)
            shards = mesh.size if name == "sharded" else 1
            assert moved == {t: c * shards for t, c in routes.items()}, (name, k)
        want = [int((values == key).sum()) for key in keys]
        bits, counts = results["list"]
        assert counts.tolist() == want
        assert torch.equal(results["tensor"][0], bits) and torch.equal(results["tensor"][1], counts)
        sbits, scounts = results["sharded"]
        assert torch.equal(scan.bits_to_canonical(dist.fetch_global(sbits, mesh), N), bits)
        assert scounts.tolist() == want


@pytest.mark.parametrize("width", (20, 24, 31))
def test_host_keys_take_the_window_lookup_at_its_points(width, monkeypatch):
    # the launch path with the CUDA calls recorded: 1030 host keys, a
    # window each, take one window lookup (the route's "window" at 1024
    # keys) and one compare launch (6 keys); the same keys as a tensor on
    # the card take the dynamic scan's lookup there
    calls = []
    monkeypatch.setattr(_cuda, "kernel_device", lambda *ts: torch.device("cpu"))
    monkeypatch.setattr(_cuda, "launch", lambda fn, device, *args: calls.append(fn))
    dev = layout.DeviceColumn(tiles=torch.zeros((width, 2, 128), dtype=torch.int32), n=100,
                              width=width)
    keys = [32 * i + i % 32 for i in range(1030)]
    fns = (scan.windowed_scan_tiles, scan.shared_scan_dynamic_tiles, scan.shared_scan_tiles)
    before = [profiling.launch_count(fn) for fn in fns]
    scan.shared_scan_device(dev, keys)
    assert calls == ["sss_windowed_lookup", "sss_shared_scan"]
    assert [profiling.launch_count(fn) - b for fn, b in zip(fns, before)] == [1, 0, 1]
    calls.clear()
    scan.shared_scan_tiles(dev.tiles, torch.tensor(keys, dtype=torch.int32), width, 100)
    assert calls == ["sss_shared_scan_dynamic", "sss_shared_scan"]


ROOT = pathlib.Path(__file__).resolve().parents[1] / "scanbench"


@pytest.mark.parametrize("cell, config, tier", [
    ("interval8", "simdscan_9bit", "interval"),
    ("any64", "simdscan_9bit", "fold"),
    ("dates64", "ssb_sf100", "fold"),
])
def test_cells_key_shapes_take_their_kernels(cell, config, tier):
    # the benchmark's shared-scan cells, their keys drawn by the cell's own
    # generator: consecutive runs on the interval kernel, 64 keys of a 9- or
    # 12-bit column on the fold, every batch
    params = json.loads((ROOT / "traffic" / f"{cell}.json").read_text())
    spec = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    width = spec["columns"][params["column"]]["bits"]
    batches = cell_keys.ops(params, spec, np.random.default_rng(7))
    for _ in range(20):
        lo, keys = scan.interval_or_keys(next(batches))
        assert tier == ("interval" if lo is not None else scan.pick_route(width, len(keys)))
