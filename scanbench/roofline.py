"""The yardstick of the roofline metrics: the card's data-sheet memory rate
and the semantic bytes of each operation, computed from shapes.

Semantic bytes count what the operation needs, not what an implementation
or a plan moves: each packed input column read once, and each output it
hands back written once.  So a later kernel or plan that reads or writes
more (or less) changes the time, never the yardstick.
"""
from __future__ import annotations

# Data-sheet device-memory rate (bytes/s) by card name, lowercased and
# without the "NVIDIA " prefix.  A copy of the port's
# ``bench/harness.py`` ``_HBM_PEAK``: the benchmark keeps its own.
HBM_PEAK = {
    "h100 80gb hbm3": 3.35e12,  # H100 SXM5
    "h100 pcie": 2.0e12,
    "h100 nvl": 3.9e12,
    "h200": 4.8e12,
    "a100-sxm4-80gb": 2.039e12,
    "a100-sxm4-40gb": 1.555e12,
    "a100 80gb pcie": 1.935e12,
    "a100-pcie-40gb": 1.555e12,
}

COUNT_BYTES = 8  # an int64 count or sum


def hbm_peak(card_name: str) -> float | None:
    """The data-sheet rate of the card called ``card_name``, or None for a
    card the table does not hold (no roofline metric is then reported)."""
    return HBM_PEAK.get(card_name.strip().lower().removeprefix("nvidia "))


def packed_bytes(rows: int, width: int) -> int:
    """Payload bytes of a column of ``rows`` values packed at ``width`` bits."""
    return (rows * width + 7) // 8


def bitvector_bytes(rows: int) -> int:
    """Bytes of an LSB-first bitvector over ``rows`` rows (uint32 words)."""
    return 4 * ((rows + 31) // 32)


def shared_scan_bytes(rows: int, width: int, k: int) -> int:
    """One shared scan of k keys: the column read, k bitvectors and k
    counts written."""
    return packed_bytes(rows, width) + k * (bitvector_bytes(rows) + COUNT_BYTES)


def query_bytes(rows: int, widths) -> int:
    """One query that answers a single number from the columns of
    ``widths``: each column read once, the answer written.  The bitvectors
    and partial sums of a plan are its own and not counted."""
    return sum(packed_bytes(rows, w) for w in widths) + COUNT_BYTES
