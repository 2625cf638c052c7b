"""Makes the raw values of ``ssb_sf100.json`` from the seed, on the device.

Each column is uniform over its domain (``seeds.uniform``) except those
that TPC-H or SSB derive: ``lo_orderkey`` is the sparse key of a uniform
order, ``lo_extendedprice`` and ``lo_supplycost`` follow the row's part
(``lo_partkey``'s stream, made again) and ``lo_quantity``, ``lo_revenue``
the price and ``lo_discount``, ``lo_commitdate`` ``lo_orderdate``.
"""
from __future__ import annotations

import torch

from scanbench.seeds import device_generator, uniform


def retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    """TPC-H 4.2.3: P_RETAILPRICE = (90000 + ((p/10) mod 20001) + 100 (p mod 1000)) / 100."""
    return 90000 + torch.remainder(partkey // 10, 20001) + 100 * torch.remainder(partkey, 1000)


def _orderkey(config, rows, seed, device):
    gen = device_generator(seed, f"{config['name']}.lo_orderkey", device)
    order = torch.randint(0, config["orders"], (rows,), generator=gen, dtype=torch.int32,
                          device=device)
    return 32 * (order // 8) + torch.remainder(order, 8) + 1


def _extendedprice(config, rows, seed, device):
    price = retail_price_cents(uniform(config, "lo_partkey", rows, seed, device))
    price *= uniform(config, "lo_quantity", rows, seed, device)
    return price


def _supplycost(config, rows, seed, device):
    return 6 * retail_price_cents(uniform(config, "lo_partkey", rows, seed, device)) // 10


def _revenue(config, rows, seed, device):
    revenue = _extendedprice(config, rows, seed, device)
    revenue *= 100 - uniform(config, "lo_discount", rows, seed, device)
    return revenue // 100


def _commitdate(config, rows, seed, device):
    gen = device_generator(seed, f"{config['name']}.lo_commitdate", device)
    days = torch.randint(30, 91, (rows,), generator=gen, dtype=torch.int32, device=device)
    days += uniform(config, "lo_orderdate", rows, seed, device)
    return days


DERIVED = {"lo_orderkey": _orderkey, "lo_extendedprice": _extendedprice,
           "lo_supplycost": _supplycost, "lo_revenue": _revenue, "lo_commitdate": _commitdate}


def make(config: dict, column: str, rows: int, seed: int, device) -> torch.Tensor:
    """The raw values of ``column`` (int32[rows]) for run seed ``seed``."""
    if column in DERIVED:
        return DERIVED[column](config, rows, seed, device)
    return uniform(config, column, rows, seed, device)
