"""Frame-of-reference (FOR) encoding over the bit-packed column.

PyTorch counterpart of ``shared_simd_scan_tpu/forcol.py``.  Columns that
live in a narrow band far from zero (timestamps, ids, prices in cents) are
stored as ``v - min`` at ``ceil(log2(max - min + 1))`` bits, which cuts the
width and so the scan traffic.  No kernel is new: predicates are REWRITTEN
onto the offset column (``v == key`` becomes ``v - base == key - base``;
out-of-band predicates become constants), so every kernel tier, the query
planner, the aggregates and the statistics run unchanged at the narrower
width.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shared_simd_scan_tpu_torch import query as q, stats as _stats
from shared_simd_scan_tpu_torch.layout import DeviceColumn, resolve_device
from shared_simd_scan_tpu_torch.ops.aggregate import masked_aggregate_device
from shared_simd_scan_tpu_torch.ops.unpack import pack_device_kernel, unpack_device


@dataclasses.dataclass(frozen=True)
class ForColumn:
    """base + packed offsets: logical value i = base + unpacked(dev)[i]."""

    base: int
    dev: DeviceColumn

    @property
    def n(self) -> int:
        return self.dev.n

    @property
    def width(self) -> int:
        return self.dev.width


def pack_for(values, width: int | None = None, *, device=None) -> ForColumn:
    """FOR-encode: subtract the minimum, pack at the minimal width (or an
    explicit wider one).  Values may span any band of < 2^31.  ``values``
    is what ``layout.pack`` takes: host values (reckoned in numpy uint64,
    as the JAX package does) or a tensor (reckoned in int64 on its device;
    int32 holds uint32 bits).  The column lies on ``device``, by default a
    tensor's own device and the card for host data."""
    if isinstance(values, torch.Tensor):
        v = values.to(device if device is not None else values.device)
        v = v.to(torch.int64) & 0xFFFFFFFF if v.dtype == torch.int32 else v.to(torch.int64)
        if v.numel() == 0:
            raise ValueError("cannot FOR-encode an empty column")
        base = int(v.min())
        offs = v - base
    else:
        values = np.asarray(values, dtype=np.uint64)
        if values.size == 0:
            raise ValueError("cannot FOR-encode an empty column")
        base = int(values.min())
        offs = values - np.uint64(base)
    span = int(offs.max()) + 1
    need = max(1, int(np.ceil(np.log2(span))) if span > 1 else 1)
    if width is None:
        width = need
    if width < need or width > 31:
        raise ValueError(
            f"width {width} cannot hold offsets up to {span - 1}"
        )
    if isinstance(offs, torch.Tensor):
        offs = offs.to(torch.int32)
    else:
        offs = torch.from_numpy(offs.astype(np.int32)).to(resolve_device(device))
    return ForColumn(base=base, dev=pack_device_kernel(offs, width))


def unpack_for(fc: ForColumn) -> np.ndarray:
    """Decode back to the logical values (host numpy uint64)."""
    out = unpack_device(fc.dev).cpu().numpy().view(np.uint32).astype(np.uint64)
    out += np.uint64(fc.base)
    return out


def _dom(fc: ForColumn) -> int:
    return 1 << fc.width


def normalize(expr):
    """Rewrite every ForColumn leaf onto its offset DeviceColumn with
    shifted/clamped predicate constants.  DeviceColumn leaves pass
    through; the result evaluates with the ordinary query planner."""
    if isinstance(expr, q.Range):
        if not isinstance(expr.col, ForColumn):
            return expr
        fc = expr.col
        lo = max(int(expr.lo) - fc.base, 0)
        hi = min(int(expr.hi) - fc.base, _dom(fc))
        if hi <= lo:
            return q.In(fc.dev, [])  # statically empty
        return q.Range(fc.dev, lo, hi)
    if isinstance(expr, q.In):
        if not isinstance(expr.col, ForColumn):
            return expr
        fc = expr.col
        keys = [
            int(k) - fc.base
            for k in expr.keys
            if fc.base <= int(k) < fc.base + _dom(fc)
        ]
        return q.In(fc.dev, keys)
    if isinstance(expr, q.Not):
        return q.Not(normalize(expr.term))
    if isinstance(expr, q.And):
        return q.And(*[normalize(t) for t in expr.terms])
    if isinstance(expr, q.Or):
        return q.Or(*[normalize(t) for t in expr.terms])
    raise TypeError(f"not a query expression: {expr!r}")


def evaluate(expr):
    """query.evaluate over a tree that may mix ForColumn and DeviceColumn
    leaves (all of the same n)."""
    return q.evaluate(normalize(expr))


def masked_aggregate(fc: ForColumn, bits):
    """SUM + COUNT of a FOR-encoded measure column over a match
    bitvector: exact logical sum = offset sum + base * count, in Python
    ints (the product can pass 2^63)."""
    s, c = masked_aggregate_device(fc.dev, bits)
    return int(s) + fc.base * int(c), c


def describe(fc: ForColumn) -> dict:
    """stats.describe shifted back to logical values."""
    d = _stats.describe(fc.dev)
    if d["n"]:
        for key in ("min", "max", "mean", "median"):
            d[key] = d[key] + fc.base
    return d


def quantiles(fc: ForColumn, qs):
    return _stats.quantiles(fc.dev, qs).astype(np.uint64) + np.uint64(fc.base)


__all__ = [
    "ForColumn",
    "pack_for",
    "unpack_for",
    "normalize",
    "evaluate",
    "masked_aggregate",
    "describe",
    "quantiles",
]
