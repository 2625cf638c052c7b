"""Column statistics from one histogram pass: quantiles, top-k, describe.

PyTorch counterpart of ``shared_simd_scan_tpu/stats.py`` (its unsharded
part).  The value domain of a width-w column is small (2^w), so order
statistics over billions of rows reduce to one histogram pass plus
O(domain) numpy on the host: no sort, no second pass over n.

A domain of at most 4096 values is one pass of
:func:`ops.scan.histogram_dag_tiles`.  A wider one (widths 13-20) is one
pass of the domain histogram, whose counts are those of the JAX package's
one ``histogram_tiles`` pass per 4096-value window laid end to end.  The
counts are copied to the host once.  Results are the JAX package's: uint64
counts and uint32 values, as numpy arrays.
"""
from __future__ import annotations

import numpy as np

from shared_simd_scan_tpu_torch.layout import DeviceColumn
from shared_simd_scan_tpu_torch.ops.scan import _histogram_domain_tiles, histogram_dag_tiles

_WINDOW = 4096


def histogram_full(dev: DeviceColumn, mesh=None) -> np.ndarray:
    """Exact counts over the FULL domain (2^width,) as host numpy uint64,
    in one kernel pass.  ``mesh`` (the JAX package's sharded statistics) is
    not ported yet: given one, this raises."""
    if dev.width > 20:
        raise ValueError(
            f"histogram statistics need 2^width buckets; width {dev.width} "
            "would take 2^(w-12) kernel passes — supported up to width 20 "
            "(256 passes)"
        )
    if mesh is not None:
        raise NotImplementedError("sharded statistics are not ported yet (ROADMAP Queue 1 "
                                  "item 12); call without mesh")
    dom = 1 << dev.width
    if dom <= _WINDOW:
        counts = histogram_dag_tiles(dev.tiles, 0, dom, dev.width, dev.n)
    else:
        counts = _histogram_domain_tiles(dev.tiles, dev.width, dev.n)
    return counts.cpu().numpy().astype(np.uint64)


def quantiles(dev: DeviceColumn, qs, mesh=None) -> np.ndarray:
    """Exact empirical quantiles (lower interpolation: the smallest value
    v with rank(v) >= ceil(q * n)) for q in ``qs``."""
    counts = histogram_full(dev, mesh=mesh)
    cum = np.cumsum(counts)
    n = int(cum[-1])
    out = []
    for q in np.atleast_1d(np.asarray(qs, np.float64)):
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile out of range: {q}")
        rank = max(1, int(np.ceil(q * n))) if n else 0
        out.append(int(np.searchsorted(cum, rank)))
    return np.asarray(out, np.uint32)


def topk_values(dev: DeviceColumn, k: int, mesh=None) -> tuple[np.ndarray, np.ndarray]:
    """The k most frequent values -> (values uint32 (k,), counts uint64),
    ordered by descending count (ties: smaller value first)."""
    counts = histogram_full(dev, mesh=mesh)
    k = min(k, counts.shape[0])
    order = np.lexsort((np.arange(counts.shape[0]), -counts.astype(np.int64)))
    top = order[:k]
    return top.astype(np.uint32), counts[top]


def describe(dev: DeviceColumn, mesh=None) -> dict:
    """min / max / mean / median / distinct-count summary, one pass."""
    counts = histogram_full(dev, mesh=mesh)
    nz = np.nonzero(counts)[0]
    n = int(counts.sum())
    if not nz.size:
        return {"n": 0, "min": None, "max": None, "mean": None,
                "median": None, "distinct": 0}
    vals = nz.astype(np.uint64)
    total = int((vals * counts[nz]).sum())
    cum = np.cumsum(counts)
    median = int(np.searchsorted(cum, (n + 1) // 2))
    return {
        "n": n,
        "min": int(nz[0]),
        "max": int(nz[-1]),
        "mean": total / n,
        "median": median,
        "distinct": int(nz.size),
    }


__all__ = ["histogram_full", "quantiles", "topk_values", "describe"]
