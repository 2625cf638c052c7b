"""Makes the raw values of ``ssb_sf100_datesorted.json`` from the seed, on
the device.

The table is ``ssb_sf100``'s for the same seed (``configs/ssb_sf100.py``'s
``make`` under that configuration's name) with its rows permuted by one
stable sort on the configuration's ``sort_key`` (``lo_orderdate``, then
``lo_orderkey``), every column alike.  So every flight-1 answer equals
``ssb_sf100.flight1``'s for the same seed.  The permutation is made again
for each column and dropped with it: none stays on the device.
"""
from __future__ import annotations

import torch

from scanbench.configs import ssb_sf100


def _unsorted(config: dict) -> dict:
    return dict(config, name="ssb_sf100")


def order(config: dict, rows: int, seed: int, device) -> torch.Tensor:
    """The permutation (int64[rows]) that sorts ``ssb_sf100``'s rows by the
    sort key, rows that tie in their ``ssb_sf100`` order."""
    base = _unsorted(config)
    first, second = config["sort_key"]
    key = ssb_sf100.make(base, first, rows, seed, device).to(torch.int64)
    key <<= config["columns"][second]["bits"]
    key += ssb_sf100.make(base, second, rows, seed, device)
    return torch.argsort(key, stable=True)


def make(config: dict, column: str, rows: int, seed: int, device) -> torch.Tensor:
    """The raw values of ``column`` (int32[rows]) for run seed ``seed``."""
    perm = order(config, rows, seed, device)
    return ssb_sf100.make(_unsorted(config), column, rows, seed, device)[perm]
