"""Flight 1 on a date-sorted table through the zone map: the conjunction and
the masked sum over a block-row span, the pruned planner entry, the
date-sorted configuration's maker and its benchmark cell, on the CPU.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
package runs in interpret mode.  Words and counts are compared exactly
(tolerance 0) with the whole-column results, the JAX package, numpy and
the benchmark's plain reference.  The CUDA kernels' spans are held against
the plain versions in test_torch_cuda.py.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanbench import harness
from scanbench.generators import ssb_flight1_zoned as zgen
from scanbench.reference import ssb_flight1 as ref
from scanbench.reference import ssb_flight1_zoned as zref
from scanbench.tests.rehearse import last_line, rehearse
from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu import zonemap as jzm
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import query as tq
from shared_simd_scan_tpu_torch import zonemap as tzm
from shared_simd_scan_tpu_torch.ops import aggregate as tagg
from shared_simd_scan_tpu_torch.ops import conj as tconj
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "ssb_sf100_datesorted.flight1_zoned"
# three zones of the configuration's 64 block rows (B1 = 192), the last one ragged
CELL_ROWS = 3 * 64 * 4096 - 4093
SEED = 2147483659
SPAN_N = 5 * 8 * 4096 + 777  # 48 block rows: six zones of 8, the last one ragged
SPANS = [(0, 8), (16, 16), (8, 32), (40, 8), (0, 48)]  # start, middle, the padded end, whole


def _t32(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.uint32).view(np.int32).copy())


def _pair(values, width):
    """(JAX DeviceColumn, port DeviceColumn) of the same tiles."""
    jdev = jlayout.pack_device(jnp.asarray(values), width)
    return jdev, tlayout.from_jax_numpy(width, values.size, np.asarray(jdev.tiles), "cpu")


def _rows_of(n):
    """Block row of each value under the device layout."""
    return np.arange(n) // (128 * 32)


@pytest.fixture(scope="module")
def span_columns():
    rng = np.random.default_rng(26)
    values = {w: rng.integers(0, 1 << w, SPAN_N, dtype=np.uint64).astype(np.uint32)
              for w in (3, 9, 24)}
    return values, {w: tlayout.pack_device(v, w, device="cpu") for w, v in values.items()}


@pytest.mark.parametrize("span", SPANS, ids=str)
def test_conj_span_equals_the_whole_column_there(span_columns, span):
    values, cols = span_columns
    tiles = [cols[w].tiles for w in (3, 9)]
    lows, highs = [1, 100], [7, 400]
    full, full_count = tconj.conj_range_scan_tiles(tiles, lows, highs, (3, 9), SPAN_N)
    start, count = span
    bits, total = tconj.conj_range_scan_tiles(tiles, lows, highs, (3, 9), SPAN_N, rows=span)
    want = torch.zeros_like(full)
    want[start : start + count] = full[start : start + count]
    assert torch.equal(bits, want)
    rows = _rows_of(SPAN_N)
    mask = ((values[3] >= 1) & (values[3] < 7) & (values[9] >= 100) & (values[9] < 400)
            & (rows >= start) & (rows < start + count))
    assert int(total) == int(mask.sum())
    if span == (0, 48):
        assert int(total) == int(full_count)
    words = tconj.conj_range_scan_device([cols[3], cols[9]], lows, highs, rows=span)[0]
    np.testing.assert_array_equal(tbitvector.to_bool(words, SPAN_N).numpy(), mask)


@pytest.mark.parametrize("span", SPANS, ids=str)
def test_masked_sum_over_a_span_equals_the_whole_column(span_columns, span):
    values, cols = span_columns
    start, count = span
    rows = _rows_of(SPAN_N)
    mask = (values[3] % 3 == 1) & (rows >= start) & (rows < start + count)
    words = tbitvector.from_bool(torch.from_numpy(mask))
    measure = cols[24]
    b1 = measure.tiles.shape[1]
    full_row = tagg.bits_from_canonical(words, b1)
    span_row = tagg.bits_from_canonical(words, b1, span)
    assert torch.equal(span_row, full_row[start : start + count])
    whole = tagg.masked_aggregate_tiles(measure.tiles, full_row, 24, SPAN_N)
    got = tagg.masked_aggregate_tiles(measure.tiles, span_row, 24, SPAN_N, rows=span)
    assert [int(x) for x in got] == [int(x) for x in whole]
    total, n = tagg.masked_aggregate_device(measure, words, rows=span)
    assert int(n) == int(mask.sum())
    assert int(total) == int(values[24][mask].astype(np.int64).sum())


def test_masked_sum_over_no_rows_is_zero(span_columns):
    _, cols = span_columns
    words = torch.zeros((SPAN_N + 31) // 32, dtype=torch.int32)
    before = profiling.launch_count(tagg.masked_aggregate_tiles)
    total, n = tagg.masked_aggregate_device(cols[24], words, rows=(0, 0))
    assert (int(total), int(n)) == (0, 0)
    assert profiling.launch_count(tagg.masked_aggregate_tiles) == before


@pytest.fixture(scope="module")
def sorted_table():
    """A date-sorted table: two sorted columns (date, then a second key that
    grows with it) and two unsorted ones, each in both packages, with the
    JAX package's zone maps of the sorted two (zone_b1 = 8)."""
    rng = np.random.default_rng(27)
    date = np.sort(rng.integers(0, 512, SPAN_N)).astype(np.uint32)
    values = {"date": date, "key": (date // 2).astype(np.uint32),
              "qty": rng.integers(1, 51, SPAN_N).astype(np.uint32),
              "disc": rng.integers(0, 11, SPAN_N).astype(np.uint32)}
    widths = {"date": 9, "key": 8, "qty": 6, "disc": 4}
    pairs = {k: _pair(v, widths[k]) for k, v in values.items()}
    jmaps = {k: jzm.build_zonemap(pairs[k][0], zone_b1=8, interpret=True) for k in ("date", "key")}
    return values, pairs, jmaps


# name: (date range, key range or None, compared with the JAX package)
PRUNES = {
    "no_zone": ((600, 700), None, False),
    "one_zone": ((90, 95), None, True),
    "several_zones": ((100, 260), None, False),
    "whole_column": ((0, 512), None, False),
    "two_maps_meet": ((100, 260), (60, 90), False),
    "two_maps_apart": ((0, 60), (200, 256), True),
}


@pytest.mark.parametrize("case", sorted(PRUNES))
def test_pruned_entry_equals_evaluate_jax_and_numpy(sorted_table, case):
    values, pairs, jmaps = sorted_table
    (d0, d1), key, with_jax = PRUNES[case]
    mapped = ("date", "key") if key else ("date",)

    def build(q, side):
        c = {k: p[side] for k, p in pairs.items()}
        terms = [q.Range(c["date"], d0, d1), q.Range(c["qty"], 1, 25), q.Eq(c["disc"], 4)]
        if key:
            terms.append(q.Range(c["key"], *key))
        return q.And(*terms)

    tmaps = {id(pairs[k][1]): jmaps[k] for k in mapped}
    v = values
    want = (v["date"] >= d0) & (v["date"] < d1) & (v["qty"] < 25) & (v["disc"] == 4)
    if key:
        want &= (v["key"] >= key[0]) & (v["key"] < key[1])
    before = profiling.counters()
    bits, count, rows = tq.evaluate_pruned(build(tq, 1), tmaps)
    after = profiling.counters()
    rose = {k: after.get(k, 0) - before.get(k, 0) for k in (
        "launches.conj_range_scan_tiles", "query.count.popcount", "zonemap.pruned_empty")}
    empty = rows[1] == 0
    assert rose == {"launches.conj_range_scan_tiles": 0, "query.count.popcount": 0,
                    "zonemap.pruned_empty": int(empty)}  # the CPU runs the plain version
    assert empty == (case in ("no_zone", "two_maps_apart"))
    np.testing.assert_array_equal(tbitvector.to_bool(bits, SPAN_N).numpy(), want)
    assert int(count) == int(want.sum())
    plain_bits, plain_count = tq.evaluate(build(tq, 1))
    assert torch.equal(bits, plain_bits) and int(plain_count) == int(count)
    mapped_bits, mapped_count = tq.evaluate(build(tq, 1), zonemaps=tmaps)
    assert torch.equal(bits, mapped_bits) and int(mapped_count) == int(count)
    if not empty:  # every set bit lies in the span handed back
        outside = np.ones(SPAN_N, bool)
        outside[rows[0] * 4096 : (rows[0] + rows[1]) * 4096] = False
        assert not (tbitvector.to_bool(bits, SPAN_N).numpy() & outside).any()
    if with_jax:
        jbits, jcount = jq.evaluate(build(jq, 0), interpret=True,
                                    zonemaps={id(pairs[k][0]): jmaps[k] for k in mapped})
        np.testing.assert_array_equal(bits.numpy().view(np.uint32), np.asarray(jbits))
        assert int(jcount) == int(count)


def test_prune_conjunction_intersects_spans():
    zmap = tzm.ZoneMap(8, 48, np.arange(0, 600, 100, dtype=np.uint32),
                       np.arange(99, 600, 100, dtype=np.uint32))
    assert tzm.prune_conjunction([(zmap, 150, 250)]) == ((8, 16), 16)
    assert tzm.prune_conjunction([(zmap, 150, 250), (zmap, 210, 350)]) == ((16, 8), 8)
    assert tzm.prune_conjunction([(zmap, 0, 50), (zmap, 450, 500)]) == (None, 0)
    assert tzm.prune_conjunction([(zmap, 700, 800)]) == (None, 0)
    assert tzm.intersect_spans([(0, 16), (8, 32), (12, 2)]) == (12, 2)
    assert tzm.intersect_spans([(0, 8), (8, 8)]) is None
    with pytest.raises(ValueError, match="share b1"):
        tzm.prune_conjunction([(zmap, 0, 50), (tzm.ZoneMap(8, 16, zmap.zmin[:2],
                                                           zmap.zmax[:2]), 0, 50)])


def test_explain_names_the_pruned_span(sorted_table):
    _, pairs, jmaps = sorted_table
    date, qty = pairs["date"][1], pairs["qty"][1]
    tmaps = {id(date): jmaps["date"]}
    expr = tq.And(tq.Range(date, 100, 260), tq.Range(qty, 1, 25))
    start, count = tzm.prune_span(jmaps["date"], 100, 260)
    text = tq.explain(expr, zonemaps=tmaps)
    assert text.splitlines()[1].endswith(
        f"over block rows [{start},{start + count}) of 48, pruned by 1 zone map")
    assert tq.explain(expr) == jq.explain(jq.And(jq.Range(pairs["date"][0], 100, 260),
                                                 jq.Range(pairs["qty"][0], 1, 25)))
    assert tq.explain(tq.And(tq.Range(date, 600, 700), tq.Range(qty, 1, 25)), zonemaps=tmaps) \
        == "constant: no zone admits the mapped ranges -> zeros"


def _config(name):
    entry = next(c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == name)
    path = ROOT / entry["file"]
    return json.loads(path.read_text()), harness.config_maker(path)


def test_datesorted_table_is_ssb_sf100_reordered():
    rows, seed, device = 50021, 2147483659, torch.device("cpu")
    base, make_base = _config("ssb_sf100")
    config, make = _config("ssb_sf100_datesorted")
    assert config["columns"] == base["columns"] and config["rows"] == base["rows"]
    assert config["reduced"] == [] and config["sort_key"] == ["lo_orderdate", "lo_orderkey"]
    unsorted = harness.make_raw(base, make_base, rows, seed, device, base["columns"])
    table = harness.make_raw(config, make, rows, seed, device, config["columns"])
    for name in config["columns"]:
        assert torch.equal(torch.sort(table[name]).values, torch.sort(unsorted[name]).values)
    key = table["lo_orderdate"].to(torch.int64) * (1 << 30) + table["lo_orderkey"]
    assert bool((key[1:] >= key[:-1]).all())
    params = json.loads((ROOT / "scanbench" / "traffic" / "flight1_zoned.json").read_text())
    gen = __import__("scanbench.generators.ssb_flight1_zoned", fromlist=["ops"])
    truths = [ref.Truth(params, config, t) for t in (table, unsorted)]
    ops = gen.ops(params, config, np.random.default_rng(3))
    for _ in range(6):
        op = next(ops)
        assert np.array_equal(truths[0].numbers(op), truths[1].numbers(op))


@pytest.mark.parametrize("control", [False, True])
def test_cell_rehearsal_on_the_cpu(control):
    # the control run, with the reference's sums in float32, must not read correct
    rc, out, err = rehearse(CELL, seconds=0.5, rows=CELL_ROWS,
                            extra=["--control"] if control else [])
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is (not control)
    assert line["attempted"] > 0
    if control:
        assert line["checks"]["revenue_mismatches"]["value"] > 0
    else:
        assert line["failed"] == 0
        # the host-bound cell takes the .scan p95 alone, not the .query pair
        assert {"latency_p95_ms.scan", "setup_s"} <= set(line["metrics"])
        assert not {"queries_per_s.scan", "queries_per_s.query",
                    "latency_p95_ms.query"} & set(line["metrics"])


def _flight1_brute(raw, params, op):
    """[revenue, counts, counts] and the WHERE's words, by numpy row by row."""
    date, qty, disc, price = (raw[params[c]].numpy().astype(np.int64) for c in (
        "date_column", "quantity_column", "discount_column", "measure_column"))
    (d0, d1), (q0, q1) = op["date"], op["quantity"]
    where = (date >= d0) & (date < d1) & (qty >= q0) & (qty < q1)
    masks = [where & (disc == v) for v in op["discounts"]]
    revenue = sum(int(price[m].sum()) * v for m, v in zip(masks, op["discounts"]))
    words = [tbitvector.from_bool(torch.from_numpy(m)) for m in masks]
    return np.asarray([revenue] + [int(m.sum()) for m in masks] * 2, np.int64), words


def test_cell_reference_and_port_agree_with_brute_force_and_catch_a_flipped_bit():
    config, make = _config("ssb_sf100_datesorted")
    params = json.loads((ROOT / "scanbench" / "traffic" / "flight1_zoned.json").read_text())
    device = torch.device("cpu")
    raw = harness.make_raw(config, make, CELL_ROWS, SEED, device, zref.columns(params))
    truth = zref.Truth(params, config, raw)
    cols = harness.make_columns(config, make, CELL_ROWS, SEED, device)
    ops = zgen.ops(params, config, np.random.default_rng(7))
    batch = [next(ops) for _ in range(6)]
    before = profiling.counters()
    for op in batch:
        numbers, words = _flight1_brute(raw, params, op)
        assert all(v == 0 for v in zref.compare(numbers, truth.numbers(op)).values())
        assert all(torch.equal(w, g) for w, g in zip(truth.words(op), words))
        got, got_words = zgen.call(params, cols, op, harness._no_span)
        assert all(v == 0 for v in zref.compare(got, numbers).values())
        assert all(torch.equal(w, g) for w, g in zip(words, got_words))
    after = profiling.counters()
    zmap = batch[0]["zonemap"]
    assert (zmap.zone_b1, zmap.b1) == (64, 192)
    # one pruned pass each discount value, none of it over the whole column
    assert after["zonemap.block_rows_scanned"] - before.get("zonemap.block_rows_scanned", 0) \
        < 18 * 192
    assert after.get("query.count.popcount", 0) == before.get("query.count.popcount", 0)
    # the port on a discount column with the lowest bit of row 0 flipped, asked
    # about row 0, disagrees with the reference
    d0, q0, v0 = (int(raw[params[c]][0]) for c in ("date_column", "quantity_column",
                                                    "discount_column"))
    op = dict(batch[0], date=(d0, d0 + 1), quantity=(q0, q0 + 1), discounts=(v0,))
    numbers, _ = zgen.call(params, cols, op, harness._no_span)
    assert sum(zref.compare(numbers, truth.numbers(op)).values()) == 0
    cols[params["discount_column"]].tiles.view(-1)[0] ^= 1
    numbers, words = zgen.call(params, cols, op, harness._no_span)
    assert sum(zref.compare(numbers, truth.numbers(op)).values()) > 0
    assert any(not torch.equal(w, g) for w, g in zip(truth.words(op), words))


# a fault planted under the pruned path: (module, wrapper) the fault replaces
FAULTS = {"stale": ("aggregate", "masked_aggregate_tiles"),
          "half": ("conj", "conj_range_scan_tiles"),
          "flip": ("conj", "conj_range_scan_tiles")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cell_fault_is_not_correct(fault):
    module, name = FAULTS[fault]
    setup = ("from scanbench.tests import faults\n"
             f"from shared_simd_scan_tpu_torch.ops import {module}\n"
             f"faults.{fault}({module}, {name!r})")
    rc, out, err = rehearse(CELL, seconds=0.5, rows=CELL_ROWS, setup=setup)
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0
