"""Reference of SSB query flight 1: one exact GROUP BY (day, quantity,
discount) of the rows' count and SUM(lo_extendedprice), from which every
query's counts and revenue are sums of a slice."""
from __future__ import annotations

import numpy as np
import torch

from scanbench.reference.words import blockwise, pack_bits


def columns(params: dict) -> list[str]:
    return [params[c] for c in ("date_column", "quantity_column", "discount_column",
                                "measure_column")]


class Truth:
    def __init__(self, params: dict, config: dict, raw: dict):
        cols = config["columns"]
        self.names = [params[c] for c in ("date_column", "quantity_column", "discount_column")]
        self.raw, self.measure = raw, raw[params["measure_column"]]
        self.shape = tuple(cols[c]["max"] + 1 for c in self.names)
        cells = self.shape[0] * self.shape[1] * self.shape[2]
        device = self.measure.device
        counts = torch.zeros(cells, dtype=torch.int64, device=device)
        sums = torch.zeros(cells, dtype=torch.int64, device=device)
        date, qty, disc = (raw[c] for c in self.names)
        for s in blockwise(date.shape[0]):
            idx = ((date[s].to(torch.int64) * self.shape[1] + qty[s]) * self.shape[2] + disc[s])
            counts += torch.bincount(idx, minlength=cells)
            sums.index_add_(0, idx, self.measure[s].to(torch.int64))
        self.counts = counts.cpu().numpy().reshape(self.shape)
        self.sums = sums.cpu().numpy().reshape(self.shape)

    def numbers(self, op: dict) -> np.ndarray:
        """[revenue, the WHERE's count a discount value, the same counts
        again (the aggregate's)]."""
        (d0, d1), (q0, q1) = op["date"], op["quantity"]
        sums = self.sums[d0:d1, q0:q1].sum(axis=(0, 1))
        counts = self.counts[d0:d1, q0:q1].sum(axis=(0, 1))
        vs = op["discounts"]
        revenue = sum(v * int(sums[v]) for v in vs)
        return np.asarray([revenue] + [int(counts[v]) for v in vs] * 2, dtype=np.int64)

    def mask(self, op: dict, v: int) -> torch.Tensor:
        date, qty, disc = (self.raw[c] for c in self.names)
        (d0, d1), (q0, q1) = op["date"], op["quantity"]
        return (date >= d0) & (date < d1) & (qty >= q0) & (qty < q1) & (disc == v)

    def words(self, op: dict) -> list[torch.Tensor]:
        return [pack_bits(self.mask(op, v)) for v in op["discounts"]]


def compare(got: np.ndarray, expected: np.ndarray) -> dict[str, int]:
    got = np.asarray(got)
    return {"revenue_mismatches": int(got[0] != expected[0]),
            "count_mismatches": int((got[1:] != expected[1:]).sum())}


def control_call(params: dict, config: dict, raw: dict, op: dict, span):
    """The reference in the program's place with each SUM accumulated in
    float32 (the guarantee broken: an exact integer sum)."""
    (d0, d1), (q0, q1) = op["date"], op["quantity"]
    date, qty, disc = (raw[params[c]] for c in ("date_column", "quantity_column",
                                                "discount_column"))
    measure = raw[params["measure_column"]]
    words, sums, counts = [], [], []
    for v in op["discounts"]:
        with span("evaluate"):
            mask = (date >= d0) & (date < d1) & (qty >= q0) & (qty < q1) & (disc == v)
            words.append(pack_bits(mask))
            counts.append(mask.sum())
        with span("masked_aggregate_device"):
            sums.append(torch.where(mask, measure, 0).to(torch.float32).sum())
    host_sums = torch.stack(sums).cpu().numpy()
    host_counts = torch.stack(counts).cpu().numpy()
    revenue = sum(v * int(s) for v, s in zip(op["discounts"], host_sums))
    return np.asarray([revenue] + list(host_counts) * 2, dtype=np.int64), words
