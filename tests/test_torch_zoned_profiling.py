"""The pruned planner's span and counters (``utils.profiling``) and the
benchmark's readers of them, on the CPU.

``query.prune`` (a mapped And's zone lookups and span intersection) nests
under ``query.evaluate`` and not ``query.plan``; ``zonemap.block_rows_scanned``,
``zonemap.block_rows_admitted`` and ``zonemap.pruned_empty`` count the block
rows a pruned pass reads, those of the zones the maps admit, and the prunes
that launched nothing.  The readers ``prune_host_ms``, ``overscan_pct`` and
``zoned_roofline`` return a number on a CPU rehearsal of their cell where
it can have one, and None where the program has no such span or counter.
No JAX.
"""
import importlib
import types

import numpy as np
import pytest
import torch

from scanbench.tests.rehearse import last_line, rehearse
from shared_simd_scan_tpu_torch import layout, query, zonemap
from shared_simd_scan_tpu_torch.ops import aggregate
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 5 * 8 * 4096 + 777  # 48 block rows: six zones of 8


@pytest.fixture
def clean():
    profiling.reset_samples()
    yield
    profiling.reset_samples()


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(28)
    date = layout.pack_device(np.sort(rng.integers(0, 512, N)).astype(np.uint32), 9,
                              device="cpu")
    qty = layout.pack_device(rng.integers(1, 51, N).astype(np.uint32), 6, device="cpu")
    price = layout.pack_device(rng.integers(0, 1 << 20, N).astype(np.uint32), 20, device="cpu")
    return date, qty, price, zonemap.build_zonemap(date, zone_b1=8)


def _reader(name):
    return importlib.import_module(f"scanbench.layer_metrics.{name}").read


def test_prune_span_nests_under_evaluate_not_plan(clean, table):
    date, qty, price, zmap = table
    bits, _, rows = query.evaluate_pruned(
        query.And(query.Range(date, 100, 260), query.Range(qty, 1, 25)), {id(date): zmap})
    aggregate.masked_aggregate_device(price, bits, rows=rows)
    totals = profiling.span_totals()
    assert totals[("query.evaluate", "query.prune")][0] == 1
    assert not any("query.prune" in p and "query.plan" in p for p in totals)
    # a tree with no mapped column prunes nothing
    query.evaluate(query.And(query.Range(qty, 1, 25)), {id(date): zmap})
    assert profiling.span_totals()[("query.evaluate", "query.prune")][0] == 1


def test_counters_count_scanned_admitted_and_empty(clean, table):
    date, qty, _, zmap = table
    maps = {id(date): zmap}
    zones = np.flatnonzero((zmap.zmax >= 100) & (zmap.zmin < 260))
    span = zonemap.prune_span(zmap, 100, 260)
    for _ in range(2):
        query.evaluate_pruned(query.And(query.Range(date, 100, 260), query.Range(qty, 1, 25)),
                              maps)
    query.evaluate_pruned(query.And(query.Range(date, 600, 700), query.Range(qty, 1, 25)), maps)
    seen = profiling.counters()
    assert seen["zonemap.block_rows_scanned"] == 2 * span[1]
    assert seen["zonemap.block_rows_admitted"] == 2 * 8 * zones.size
    assert seen["zonemap.pruned_empty"] == 1
    assert seen["query.count.kernel"] == 3 and "query.count.popcount" not in seen
    # the lone Range's pruned scan counts too: its span, or the column past half
    zonemap.pruned_range_scan(date, zmap, 100, 101)
    one = np.flatnonzero((zmap.zmax >= 100) & (zmap.zmin < 101))
    after = profiling.counters()
    assert after["zonemap.block_rows_scanned"] - seen["zonemap.block_rows_scanned"] \
        == zonemap.prune_span(zmap, 100, 101)[1]
    assert after["zonemap.block_rows_admitted"] - seen["zonemap.block_rows_admitted"] \
        == 8 * one.size


@pytest.mark.parametrize("reader", ["prune_host_ms", "overscan_pct"])
def test_reader_is_none_without_its_span_or_counter(clean, reader):
    with profiling.span("query.evaluate"):
        pass
    profiling.count("query.count.kernel")
    assert _reader(reader)(None) is None


def test_zoned_roofline_reads_its_own_generator():
    seen = []
    run = types.SimpleNamespace(roofline_pct=lambda g: seen.append(g) or 12.5)
    assert _reader("zoned_roofline")(run) == 12.5 and seen == ["ssb_flight1_zoned"]


def test_readers_on_a_cpu_rehearsal():
    # the CPU runs the plain versions: no kernel, so no device time or launch span
    # three zones of the configuration's 64 block rows
    rc, out, err = rehearse("ssb_sf100_datesorted.flight1_zoned", trace=1, seconds=0.3,
                            rows=3 * 64 * 4096 - 4093)
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is True
    for name in ("prune_host_ms", "overscan_pct"):
        assert line["metrics"][name]["value"] > 0, name
    assert line["metrics"]["overscan_pct"]["value"] >= 100
    assert not {"zoned_roofline", "launch_host_ms.scan"} & set(line["metrics"])
