"""SSB query flight 1 on a ``lineorder`` stored in date order, pruned by a
zone map on its date column: ``flight1``'s queries (Q1.1, Q1.2, Q1.3 in
turn, the same constants from the same seed) through the port's pruned
planner entry.

The zone map of each column the configuration's ``zonemaps`` names, of its
``zone_b1``, is built by ``zonemap.build_zonemap`` on the first call, in
the warm-up, and kept while the column lives.  The plan:
for each discount value v of the band,
``query.evaluate_pruned(And(Range(date), Range(quantity), Eq(discount,
v)), zonemaps)``, one fused conjunction over the block rows the zone map
leaves, its count kept, then
``ops.aggregate.masked_aggregate_device(measure, bits, rows=span)`` over
that span alone; the three sums and counts are read on the host once a
query, and the answer is sum over v of v * sum_v.
"""
from __future__ import annotations

import weakref
from collections.abc import Iterator

import numpy as np
import torch

from scanbench import roofline
from scanbench.generators import ssb_flight1
from shared_simd_scan_tpu_torch import query, zonemap
from shared_simd_scan_tpu_torch.ops import aggregate
from shared_simd_scan_tpu_torch.query import evaluate_pruned

ZONE_VALUES = 128 * 32  # values a block row of the port's layout holds

# id(column) -> (the column, weakly; its zone map)
_MAPS: dict[int, tuple[weakref.ref, zonemap.ZoneMap]] = {}

queries = ssb_flight1.queries


def _zonemap(col, zone_b1: int) -> zonemap.ZoneMap:
    """The zone map of ``col``: built once, kept while the column lives."""
    kept = _MAPS.get(id(col))
    if kept is not None and kept[0]() is col:
        return kept[1]
    zmap = zonemap.build_zonemap(col, zone_b1=zone_b1)
    _MAPS[id(col)] = (weakref.ref(col), zmap)
    return zmap


def ops(params: dict, config: dict, rng: np.random.Generator) -> Iterator[dict]:
    """``flight1``'s queries, each with the configuration's zone maps
    ({column: zone_b1})."""
    zone_b1 = {c: spec["zone_b1"] for c, spec in config["zonemaps"].items()}
    for op in ssb_flight1.ops(params, config, rng):
        op["zone_b1"] = zone_b1
        yield op


def call(params: dict, data: dict, op: dict, span):
    """Run one query through the port -> (numbers read on the host:
    [revenue, the WHERE's count a discount value, the aggregate's count a
    discount value]; the WHERE's bitvectors, left on the card)."""
    date, qty = data[params["date_column"]], data[params["quantity_column"]]
    disc, measure = data[params["discount_column"]], data[params["measure_column"]]
    zmaps = {c: _zonemap(data[c], zb) for c, zb in op["zone_b1"].items()}
    op["zonemap"] = zmaps.get(params["date_column"])
    maps = {id(data[c]): zmap for c, zmap in zmaps.items()}
    words, sums, where_counts, agg_counts = [], [], [], []
    for v in op["discounts"]:
        expr = query.And(query.Range(date, *op["date"]), query.Range(qty, *op["quantity"]),
                         query.Eq(disc, v))
        with span("evaluate"):
            bits, count, rows = evaluate_pruned(expr, maps)
        with span("masked_aggregate_device"):
            total, n = aggregate.masked_aggregate_device(measure, bits, rows=rows)
        words.append(bits)
        sums.append(total)
        where_counts.append(count)
        agg_counts.append(n)
    host = torch.stack(sums + where_counts + agg_counts).cpu().numpy()
    k = len(op["discounts"])
    revenue = sum(v * int(s) for v, s in zip(op["discounts"], host[:k]))
    return np.concatenate([np.asarray([revenue], np.int64), host[k:]]), words


def admitted_rows(zmap: zonemap.ZoneMap, lo: int, hi: int, rows: int) -> int:
    """Rows of the table in the zones whose [min, max] meets [lo, hi)."""
    per = zmap.zone_b1 * ZONE_VALUES
    z = np.nonzero((zmap.zmax.astype(np.int64) >= lo) & (zmap.zmin.astype(np.int64) < hi))[0]
    return int(np.clip(np.minimum((z + 1) * per, rows) - z * per, 0, None).sum())


def semantic_bytes(params: dict, config: dict, rows: int, op: dict) -> int:
    """The query's four columns read once over the rows of the zones the
    date column's zone map admits (not the span a plan rounds them to), and
    its revenue written; over the whole table where no zone map was built
    (a control run)."""
    zmap = op.get("zonemap")
    admitted = rows if zmap is None else admitted_rows(zmap, *op["date"], rows)
    cols = config["columns"]
    return roofline.query_bytes(admitted, [cols[params[c]]["bits"] for c in (
        "date_column", "quantity_column", "discount_column", "measure_column")])
