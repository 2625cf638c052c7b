"""Shared-scan traffic: each operation is one batch of k keys on one
column, answered by one ``ops.scan.shared_scan_device`` call with host
keys: k bitvectors on the card and k counts read on the host.

Parameters (the traffic file): ``column``, ``k``, and ``keys``:
``consecutive`` (lo..lo+k-1, lo uniform over the values the column holds)
or ``any`` (k distinct keys uniform over them, in drawn order).
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from scanbench import roofline
from shared_simd_scan_tpu_torch.ops import scan as scan_ops

BLOCK = 4096  # consecutive batches drawn at a time, out of the client's way


def ops(params: dict, config: dict, rng: np.random.Generator) -> Iterator[np.ndarray]:
    """Endless batches of keys (uint32[k]) drawn from ``rng``."""
    spec = config["columns"][params["column"]]
    lo, hi, k = spec["min"], spec["max"], params["k"]
    if params["keys"] == "consecutive":
        while True:
            starts = rng.integers(lo, hi - k + 2, size=BLOCK)
            yield from (starts[:, None] + np.arange(k)).astype(np.uint32)
    elif params["keys"] == "any":
        while True:
            yield (rng.choice(hi - lo + 1, size=k, replace=False) + lo).astype(np.uint32)
    else:
        raise ValueError(f"keys must be 'consecutive' or 'any', got {params['keys']!r}")


def queries(params: dict, op: np.ndarray) -> int:
    """A batch of k keys answers k queries."""
    return int(op.shape[0])


def call(params: dict, data: dict, op: np.ndarray, span):
    """Run one batch through the port -> (numbers read on the host: the k
    counts; the k bitvectors, rows of one tensor left on the card)."""
    with span("shared_scan_device"):
        words, counts = scan_ops.shared_scan_device(data[params["column"]], op)
    return counts.cpu().numpy(), words


def semantic_bytes(params: dict, config: dict, rows: int, op: np.ndarray) -> int:
    width = config["columns"][params["column"]]["bits"]
    return roofline.shared_scan_bytes(rows, width, int(op.shape[0]))
