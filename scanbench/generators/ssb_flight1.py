"""SSB query flight 1: SELECT SUM(lo_extendedprice * lo_discount) FROM
lineorder WHERE <date range> AND <quantity range> AND lo_discount BETWEEN
d AND d + band - 1, the templates in turn (Q1.1, Q1.2, Q1.3).

Each query draws its date constant within its template's shape (a year, a
year-month, or week w of a year: days 7(w-1)..7w-1 from its first day) and
its discount band [d, d + band - 1] from the seed.  The plan: for each
discount value v of the band, ``query.evaluate(And(Range(date),
Range(quantity), Eq(discount, v)))``, then
``ops.aggregate.masked_aggregate_device(measure, bits)``; the three sums
and counts are read on the host once a query, and the answer is
sum over v of v * sum_v.
"""
from __future__ import annotations

import datetime
from collections.abc import Iterator

import numpy as np
import torch

from scanbench import roofline
from shared_simd_scan_tpu_torch import query
from shared_simd_scan_tpu_torch.ops import aggregate


def _day(epoch: datetime.date, year: int, month: int = 1, day: int = 1) -> int:
    return (datetime.date(year, month, day) - epoch).days


def _dates(epoch: datetime.date, shape: str, rng: np.random.Generator, years) -> tuple[int, int]:
    """A half-open day range of the template's shape."""
    year = int(rng.integers(years[0], years[1] + 1))
    if shape == "year":
        return _day(epoch, year), _day(epoch, year + 1)
    if shape == "yearmonth":
        month = int(rng.integers(1, 13))
        nxt = (year + 1, 1) if month == 12 else (year, month + 1)
        return _day(epoch, year, month), _day(epoch, *nxt)
    if shape == "week":
        lo = _day(epoch, year) + 7 * int(rng.integers(0, 52))
        return lo, lo + 7
    raise ValueError(f"unknown date shape {shape!r}")


def ops(params: dict, config: dict, rng: np.random.Generator) -> Iterator[dict]:
    """Endless queries, the templates in turn, constants drawn from ``rng``."""
    epoch = datetime.date.fromisoformat(config["epoch"])
    band, (dlo, dhi) = params["discount_band"], params["discount_low"]
    while True:
        for t in params["templates"]:
            date = _dates(epoch, t["date"], rng, params["years"])
            d = int(rng.integers(dlo, dhi + 1))
            yield {"template": t["name"], "date": date, "quantity": tuple(t["quantity"]),
                   "discounts": tuple(range(d, d + band))}


def queries(params: dict, op: dict) -> int:
    return 1


def call(params: dict, data: dict, op: dict, span):
    """Run one query through the port -> (numbers read on the host:
    [revenue, the WHERE's count a discount value, the aggregate's count a
    discount value]; the WHERE's bitvectors, left on the card)."""
    date, qty = data[params["date_column"]], data[params["quantity_column"]]
    disc, measure = data[params["discount_column"]], data[params["measure_column"]]
    words, sums, where_counts, agg_counts = [], [], [], []
    for v in op["discounts"]:
        expr = query.And(query.Range(date, *op["date"]), query.Range(qty, *op["quantity"]),
                         query.Eq(disc, v))
        with span("evaluate"):
            bits, count = query.evaluate(expr)
        with span("masked_aggregate_device"):
            total, n = aggregate.masked_aggregate_device(measure, bits)
        words.append(bits)
        sums.append(total)
        where_counts.append(count)
        agg_counts.append(n)
    host = torch.stack(sums + where_counts + agg_counts).cpu().numpy()
    k = len(op["discounts"])
    revenue = sum(v * int(s) for v, s in zip(op["discounts"], host[:k]))
    return np.concatenate([np.asarray([revenue], np.int64), host[k:]]), words


def semantic_bytes(params: dict, config: dict, rows: int, op: dict) -> int:
    """The query's four columns read once and its revenue written, however
    many passes the plan makes."""
    cols = config["columns"]
    return roofline.query_bytes(rows, [cols[params[c]]["bits"] for c in (
        "date_column", "quantity_column", "discount_column", "measure_column")])
