"""Nullable columns: SQL three-valued logic over match bitvectors.

PyTorch counterpart of ``shared_simd_scan_tpu/nullable.py``.  A NULL
bitvector lies next to the packed column, and predicate trees evaluate
under Kleene (SQL) semantics: a comparison against NULL is UNKNOWN,
And/Or/Not propagate (TRUE, UNKNOWN, FALSE) exactly, and the result is the
definite-TRUE set (what SQL WHERE keeps).  Everything composes from
word-wise bitvector ops; no kernel is new.

Representation: each subtree evaluates to (t, u) canonical bitvector
words, the definitely-true and unknown sets (disjoint).  Rules:

    leaf     t = match & ~null            u = null
    And      t = AND t_i                  u = AND (t_i|u_i)  & ~t
    Or       t = OR t_i                   u = OR  (t_i|u_i)  & ~t
    Not      t = valid & ~(t_in | u_in)   u = u_in

Plain (non-nullable) DeviceColumn subtrees keep the query planner's fused
passes: only subtrees touching a NullableColumn evaluate leaf by leaf (the
fused conjunction cannot recover the per-column match sets Kleene needs).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shared_simd_scan_tpu_torch import bitvector, query as q
from shared_simd_scan_tpu_torch.layout import DeviceColumn, resolve_device
from shared_simd_scan_tpu_torch.ops.unpack import pack_device_kernel


@dataclasses.dataclass(frozen=True)
class NullableColumn:
    """Packed column + canonical NULL bitvector words (bit i set = row i
    is NULL; the stored value at a NULL slot is 0 and never consulted)."""

    dev: DeviceColumn
    nulls: torch.Tensor  # int32[ceil(n/32)] (uint32 bits) on the column's device

    @property
    def n(self) -> int:
        return self.dev.n

    @property
    def width(self) -> int:
        return self.dev.width


def pack_nullable(values, null_mask, width: int, *, device=None) -> NullableColumn:
    """Pack with NULLs: values at null slots are stored as 0.  ``values``
    and ``null_mask`` are host arrays or tensors; the column lies on
    ``device``, by default a tensor's own device and the card for host
    data."""
    if isinstance(values, torch.Tensor):
        device = values.device if device is None else torch.device(device)
        v = values.to(device)
    else:
        device = resolve_device(device)
        v = torch.from_numpy(np.asarray(values, np.uint32).view(np.int32)).to(device)
    if isinstance(null_mask, torch.Tensor):
        mask = null_mask.to(device=device, dtype=torch.bool)
    else:
        mask = torch.from_numpy(np.asarray(null_mask, bool)).to(device)
    if v.shape != mask.shape:
        raise ValueError("values and null_mask must have the same shape")
    v = torch.where(mask, torch.zeros((), dtype=v.dtype, device=device), v)
    return NullableColumn(dev=pack_device_kernel(v, width), nulls=bitvector.from_bool(mask))


def _has_nullable(expr) -> bool:
    if isinstance(expr, (q.Range, q.In)):
        return isinstance(expr.col, NullableColumn)
    if isinstance(expr, q.Not):
        return _has_nullable(expr.term)
    if isinstance(expr, (q.And, q.Or)):
        return any(_has_nullable(t) for t in expr.terms)
    raise TypeError(f"not a query expression: {expr!r}")


def _strip(expr):
    """Replace NullableColumn leaves by their plain dev column."""
    if isinstance(expr, q.Range):
        if isinstance(expr.col, NullableColumn):
            return q.Range(expr.col.dev, expr.lo, expr.hi)
        return expr
    if isinstance(expr, q.In):
        if isinstance(expr.col, NullableColumn):
            return q.In(expr.col.dev, expr.keys)
        return expr
    if isinstance(expr, q.Not):
        return q.Not(_strip(expr.term))
    if isinstance(expr, q.And):
        return q.And(*[_strip(t) for t in expr.terms])
    return q.Or(*[_strip(t) for t in expr.terms])


def _eval_tu(expr, n: int, device):
    """-> (t, u) canonical word tensors for the subtree."""
    if not _has_nullable(expr):
        # pure subtree: the ordinary planner (fused passes), never unknown
        bits, _ = q.evaluate(_strip(expr))
        return bits, torch.zeros((n + 31) // 32, dtype=torch.int32, device=device)
    if isinstance(expr, (q.Range, q.In)):
        col = expr.col
        bits, _ = q.evaluate(_strip(expr))
        return bitvector.logical_andnot(bits, col.nulls), col.nulls
    if isinstance(expr, q.Not):
        t, u = _eval_tu(expr.term, n, device)
        return bitvector.logical_not(t | u, n), u
    if isinstance(expr, (q.And, q.Or)):
        # group the pure (non-nullable) siblings into ONE subtree so the
        # ordinary planner keeps its fused multi-column / k-range passes;
        # only nullable terms evaluate per-term for the Kleene algebra
        pure = [x for x in expr.terms if not _has_nullable(x)]
        mixed = [x for x in expr.terms if _has_nullable(x)]
        ctor = q.And if isinstance(expr, q.And) else q.Or
        terms = ([ctor(*pure)] if pure else []) + mixed
        ts_us = [_eval_tu(x, n, device) for x in terms]
        t = ts_us[0][0]
        tu = ts_us[0][0] | ts_us[0][1]
        if isinstance(expr, q.And):
            for ti, ui in ts_us[1:]:
                t = t & ti
                tu = tu & (ti | ui)
        else:
            for ti, ui in ts_us[1:]:
                t = t | ti
                tu = tu | ti | ui
        return t, bitvector.logical_andnot(tu, t)
    raise TypeError(f"not a query expression: {expr!r}")


def evaluate(expr):
    """SQL-WHERE semantics: -> (definitely-true bitvector words, int64
    count).  Rows where the predicate is UNKNOWN (NULL involved) are
    excluded, exactly as SQL filters them."""
    cols = []

    def walk(e):
        if isinstance(e, (q.Range, q.In)):
            cols.append(e.col)
        elif isinstance(e, q.Not):
            walk(e.term)
        elif isinstance(e, (q.And, q.Or)):
            for x in e.terms:
                walk(x)

    walk(expr)
    if not cols:
        raise ValueError("query references no columns")
    n = cols[0].n
    for c in cols:
        if c.n != n:
            raise ValueError("query columns must share n")
    device = cols[0].dev.tiles.device if isinstance(cols[0], NullableColumn) \
        else cols[0].tiles.device
    t, _ = _eval_tu(expr, n, device)
    return t, bitvector.popcount(t)


__all__ = ["NullableColumn", "pack_nullable", "evaluate"]
