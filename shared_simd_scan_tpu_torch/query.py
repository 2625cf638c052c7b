"""Predicate-tree query layer: compose column predicates, evaluate fused.

PyTorch counterpart of ``shared_simd_scan_tpu/query.py``.  A small
algebra of predicates over same-table packed columns:

    Eq(col, key)        column == key
    Range(col, lo, hi)  lo <= column < hi        (half-open)
    In(col, keys)       column IN keys
    And(*terms) / Or(*terms) / Not(term)

``evaluate(expr)`` plans the tree onto the kernel tiers instead of
evaluating it leaf by leaf:

- every Range/Eq conjunct of an And is merged per column (intersected
  bounds) and each group of up to 8 columns runs as one fused pass
  (:mod:`ops.conj`), reading each column once and writing one bitvector;
- the Eq and In disjuncts of an Or on one column merge into one member
  scan (:mod:`ops.member`), and its multi-value ranges share one k-range
  pass (:func:`ops.scan.range_scan_tiles`, 32 ranges per call);
- the remaining boolean structure composes the bitvectors word-wise
  (:mod:`bitvector`);
- with ``zonemaps``, a Range/Eq on a mapped column scans only the blocks
  its zones allow (:func:`zonemap.pruned_range_scan`), and an And whose
  groups hold mapped columns runs each group once over the intersection
  of their pruned spans; ``evaluate_pruned`` also hands that span back, for
  the masked aggregate to read it alone.

Predicate constants are host values, which is what lets the planner pick
tiers statically; columns are DeviceColumns of the same n.  Returns
(canonical bitvector words int32[ceil(n/32)], int64 count) with bits at
i >= n zero.

``evaluate_sharded(expr, mesh)`` plans the same tree over columns sharded
along the block axis (``parallel.dist.shard_column``): the leaves run the
sharded scans, the bitvectors stay one int32[B1/S, 128] tensor a shard,
the boolean structure composes them shard by shard, and only the final
count is all-reduced over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from shared_simd_scan_tpu_torch import bitvector, zonemap
from shared_simd_scan_tpu_torch.layout import DeviceColumn
from shared_simd_scan_tpu_torch.ops import conj as conj_ops
from shared_simd_scan_tpu_torch.ops import member as member_ops
from shared_simd_scan_tpu_torch.ops import scan as scan_ops
from shared_simd_scan_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Range:
    """lo <= col < hi (half-open, unsigned)."""

    col: DeviceColumn
    lo: int
    hi: int


def Eq(col: DeviceColumn, key: int) -> Range:
    """col == key: the degenerate range [key, key+1)."""
    return Range(col, int(key), int(key) + 1)


@dataclasses.dataclass(frozen=True)
class In:
    """col IN keys (a concrete key set: a list, numpy array or CPU tensor).
    A CUDA tensor raises TypeError: the planner reads the keys on the
    host, and it does not copy them there unasked."""

    col: DeviceColumn
    keys: tuple

    def __init__(self, col: DeviceColumn, keys: Sequence[int]):
        if isinstance(keys, torch.Tensor):
            if keys.is_cuda:
                raise TypeError("In takes concrete keys; copy a CUDA tensor of keys to the host "
                                "first, or scan it with ops.member.member_scan_device")
            keys = keys.numpy()
        object.__setattr__(self, "col", col)
        object.__setattr__(self, "keys", tuple(int(k) for k in np.asarray(keys).ravel()))


@dataclasses.dataclass(frozen=True)
class And:
    terms: tuple

    def __init__(self, *terms):
        object.__setattr__(self, "terms", tuple(terms))


@dataclasses.dataclass(frozen=True)
class Or:
    terms: tuple

    def __init__(self, *terms):
        object.__setattr__(self, "terms", tuple(terms))


@dataclasses.dataclass(frozen=True)
class Not:
    term: object


def _columns(expr) -> list[DeviceColumn]:
    if isinstance(expr, (Range, In)):
        return [expr.col]
    if isinstance(expr, (And, Or)):
        return [c for t in expr.terms for c in _columns(t)]
    if isinstance(expr, Not):
        return _columns(expr.term)
    raise TypeError(f"not a query expression: {expr!r}")


def _group_or_terms(terms):
    """Plan an Or's children: per column, (multi-value spans) and (merged
    member keys from In terms and single-value Eq spans); plus the
    residual non-leaf terms.  Statically empty disjuncts are dropped."""
    spans_by_col: dict[int, tuple[DeviceColumn, list]] = {}
    keys_by_col: dict[int, tuple[DeviceColumn, list]] = {}
    others = []
    for t in terms:
        if isinstance(t, Range) and t.hi == t.lo + 1:
            keys_by_col.setdefault(id(t.col), (t.col, []))[1].append(t.lo)
        elif isinstance(t, Range) and t.lo < t.hi:
            spans_by_col.setdefault(id(t.col), (t.col, []))[1].append((t.lo, t.hi))
        elif isinstance(t, Range):
            pass  # statically empty disjunct
        elif isinstance(t, In):
            if t.keys:
                keys_by_col.setdefault(id(t.col), (t.col, []))[1].extend(t.keys)
        else:
            others.append(t)
    # dedupe merged keys, preserving order for determinism
    for cid, (col, keys) in list(keys_by_col.items()):
        keys_by_col[cid] = (col, list(dict.fromkeys(keys)))
    return spans_by_col, keys_by_col, others


def _group_and_terms(terms):
    """Plan an And's children: per-column intersected range bounds
    (chunked into conj-kernel groups of MAX_COLUMNS) plus the residual
    terms.  Returns (groups, others, empty); empty is True when some
    column's intersection is statically empty."""
    bounds: dict[int, tuple[DeviceColumn, int, int]] = {}
    others = []
    for t in terms:
        if isinstance(t, Range):
            key = id(t.col)
            if key in bounds:
                col, lo, hi = bounds[key]
                bounds[key] = (col, max(lo, t.lo), min(hi, t.hi))
            else:
                bounds[key] = (t.col, t.lo, t.hi)
        else:
            others.append(t)
    groups = list(bounds.values())
    empty = any(hi <= lo for _, lo, hi in groups)
    chunks = [groups[at : at + conj_ops.MAX_COLUMNS]
              for at in range(0, len(groups), conj_ops.MAX_COLUMNS)]
    return chunks, others, empty


def _conj_bounds(group) -> tuple[list[DeviceColumn], np.ndarray, np.ndarray]:
    """A conjunction group's (columns, lows, highs) as the conj kernel
    takes them."""
    return ([c for c, _, _ in group], np.asarray([lo for _, lo, _ in group], np.uint32),
            np.asarray([hi for _, _, hi in group], np.uint32))


def _combine(op, rows):
    """Word-wise ``op`` of (bits, count, span) rows -> (bits, count, span).
    A lone row is returned whole (``op`` of one row is that row) with its
    count and span; a real combine has neither.  Span ``query.compose``."""
    with profiling.span("query.compose"):
        bits = op(*(r[0] for r in rows))
    return (bits, *rows[0][1:]) if len(rows) == 1 else (bits, None, None)


def _mapped_bounds(chunks, zonemaps) -> list:
    """(ZoneMap, lo, hi) of each mapped column of an And's groups."""
    return [(zonemaps[id(c)], lo, hi) for g in chunks for c, lo, hi in g
            if id(c) in zonemaps] if zonemaps else []


def _eval(expr, n: int, device, zonemaps: dict | None = None):
    """-> (canonical bitvector words of the subtree, their int64 count or
    None, the block-row span (start, count) outside which the words are
    zero or None).

    The count is the one the kernel that wrote the words returned (the
    fused conjunction, the member scan, the zone-pruned range scan), as
    long as no combine changed them since; None where the planner combined
    rows (two or more, or a NOT) or made the words itself (zeros).  The
    span is a pruned And's (count 0 for zeros the planner made); None
    where any row may be set.

    ``zonemaps`` maps ``id(col)`` -> :class:`zonemap.ZoneMap`: a lone
    Range/Eq on a mapped column scans only its pruned block span
    (:func:`zonemap.pruned_range_scan`).  An And's Range conjuncts merge
    per column first; where its groups hold mapped columns, their pruned
    spans intersect (:func:`zonemap.prune_conjunction`) and every group
    runs as one fused pass over that span alone, its count kept; spans
    that do not meet launch nothing: zeros, count 0.

    Spans: ``query.plan`` around the grouping and the bound arrays,
    ``query.prune`` around the zone lookups and the span intersection,
    ``query.compose`` around the word-wise combines; the leaves'
    operators have their own.  Counters ``zonemap.block_rows_scanned``
    (block rows each pruned pass reads), ``zonemap.block_rows_admitted``
    (those of the zones every mapped column admits) and
    ``zonemap.pruned_empty`` (prunes that launched nothing)."""

    def zeros():
        return torch.zeros((n + 31) // 32, dtype=torch.int32, device=device), None, (0, 0)

    if isinstance(expr, Range):
        zm = (zonemaps or {}).get(id(expr.col))
        if zm is not None:
            return *zonemap.pruned_range_scan(expr.col, zm, int(expr.lo), int(expr.hi)), None
        return _eval(And(expr), n, device)
    if isinstance(expr, In):
        if not expr.keys:
            return zeros()
        with profiling.span("query.plan"):
            keys = np.asarray(expr.keys, np.uint32)
        return *member_ops.member_scan_device(expr.col, keys), None
    if isinstance(expr, Not):
        term = _eval(expr.term, n, device, zonemaps)[0]
        with profiling.span("query.compose"):
            return bitvector.logical_not(term, n), None, None
    if isinstance(expr, Or):
        if not expr.terms:
            return zeros()
        # Eq and In disjuncts of one column merge into one member scan (the
        # union is the member semantics); its multi-value ranges share one
        # k-range pass per 32 ranges
        with profiling.span("query.plan"):
            spans_by_col, keys_by_col, others = _group_or_terms(expr.terms)
        rows = [_eval(t, n, device, zonemaps) for t in others]
        for col, keys in keys_by_col.values():
            rows.append(_eval(In(col, keys), n, device, zonemaps))
        for col, spans in spans_by_col.values():
            if len(spans) == 1:
                # a single range: the conj kernel writes the one fused row
                rows.append(_eval(Range(col, *spans[0]), n, device, zonemaps))
                continue
            for at in range(0, len(spans), 32):
                with profiling.span("query.plan"):
                    g = spans[at : at + 32]
                    lows = np.asarray([lo for lo, _ in g], np.uint32)
                    highs = np.asarray([hi for _, hi in g], np.uint32)
                kbits, _ = scan_ops.range_scan_device(col, lows, highs)
                with profiling.span("query.compose"):
                    rows.append((bitvector.logical_or(*kbits), None, None))
        if not rows:
            return zeros()
        return _combine(bitvector.logical_or, rows)
    if isinstance(expr, And):
        if not expr.terms:
            with profiling.span("query.compose"):
                return bitvector.logical_not(zeros()[0], n), None, None
        # every Range conjunct merges per column: intersected bounds, one
        # fused multi-column pass per group
        with profiling.span("query.plan"):
            chunks, others, empty = _group_and_terms(expr.terms)
            groups = [] if empty else [_conj_bounds(g) for g in chunks]
        if empty:
            return zeros()
        span = None
        mapped = _mapped_bounds(chunks, zonemaps)
        if mapped:
            # the mapped columns' spans meet in one span; every group scans it
            with profiling.span("query.prune"):
                span, admitted = zonemap.prune_conjunction(mapped)
            if span is None:
                profiling.count("zonemap.pruned_empty")
                return zeros()[0], torch.zeros((), dtype=torch.int64, device=device), (0, 0)
            profiling.count("zonemap.block_rows_admitted", admitted)
            profiling.count("zonemap.block_rows_scanned", span[1] * len(groups))
        rows = [(*conj_ops.conj_range_scan_device(cols, lows, highs, rows=span), span)
                for cols, lows, highs in groups]
        rows.extend(_eval(t, n, device, zonemaps) for t in others)
        bits, count, sub = _combine(bitvector.logical_and, rows)
        return bits, count, span if mapped else sub
    raise TypeError(f"not a query expression: {expr!r}")


def evaluate(expr, zonemaps: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a predicate tree -> (canonical bitvector words, int64
    count).

    ``zonemaps``: optional ``{id(col): zonemap.ZoneMap}`` (built by either
    package): Range/Eq leaves on mapped columns scan only the pruned block
    span, and an And whose groups hold mapped columns runs them once over
    the intersection of their spans.  Build with ``{id(col):
    zonemap.build_zonemap(col)}``.

    The count is the one the kernel that wrote the final words returned,
    where no combine changed them since (counter ``query.count.kernel``),
    else :func:`bitvector.popcount` of the words (``query.count.popcount``).

    Span ``query.evaluate`` holds ``query.plan`` (the columns' checks, the
    grouping, the bound arrays), ``query.prune`` (a mapped And's zone
    lookups and span intersection), the leaves' operator spans,
    ``query.compose`` (the word-wise combines) and ``query.popcount`` (the
    count step, either way)."""
    bits, count, _ = evaluate_pruned(expr, zonemaps)
    return bits, count


def evaluate_pruned(expr, zonemaps: dict | None) -> tuple[torch.Tensor, torch.Tensor,
                                                           tuple[int, int] | None]:
    """:func:`evaluate` -> (canonical bitvector words, int64 count, rows):
    ``rows`` is the block-row span (start, count) outside which every bit
    is zero -- a mapped And's pruned span, count 0 where nothing can match
    -- or None where any row may be set.  Hand it to
    ``ops.aggregate.masked_aggregate_device(..., rows=rows)``, which then
    reads that span alone."""
    with profiling.span("query.evaluate"):
        with profiling.span("query.plan"):
            cols = _columns(expr)
            if not cols:
                raise ValueError("query references no columns")
            n = cols[0].n
            for c in cols:
                if c.n != n:
                    raise ValueError(f"query columns must share n, got {c.n} != {n}")
        bits, count, span = _eval(expr, n, cols[0].tiles.device, zonemaps)
        with profiling.span("query.popcount"):
            if count is not None:
                profiling.count("query.count.kernel")
                return bits, count, span
            profiling.count("query.count.popcount")
            return bits, bitvector.popcount(bits), span


# ---------------------------------------------------------------------------
# Sharded evaluation
# ---------------------------------------------------------------------------
#
# The same planning over columns sharded along the block axis: the leaves
# run the sharded kernel wrappers and return their bits as one
# device-layout int32[B1/S, 128] tensor a shard; the boolean composition
# is word-wise torch on each shard, with no collective at all; only the
# final count is all-reduced.  NOT re-zeroes the padding blocks (zero in
# every kernel output, but the complement would set them) at each shard's
# block offset.


def _complement(bits: list[torch.Tensor], col) -> list[torch.Tensor]:
    """NOT of sharded bits: each shard's words complemented, then its words
    at or past n zeroed and the tail word masked (``bitvector.logical_not``
    on each shard at its block offset), so padding blocks stay zero."""
    full, rem = divmod(col.n, 32)
    out = []
    for i, b in enumerate(bits):
        words = (~b).reshape(-1)
        first = full - col.block_offset(i)  # this shard's first word not wholly valid
        if first < words.shape[0]:
            if rem and first >= 0:
                words[first] &= (1 << rem) - 1  # < 2^31: a valid int32 mask
                first += 1
            words[max(first, 0) :] = 0
        out.append(words.reshape(b.shape))
    return out


def _eval_sharded(expr, col, mesh) -> list[torch.Tensor]:
    """-> the subtree's bits, a list of int32[B1/S, 128] per shard; ``col``
    is any column of the query (for its shards' shape)."""
    from shared_simd_scan_tpu_torch.parallel import dist

    def zeros():
        return [torch.zeros((col.local_b1, 128), dtype=torch.int32, device=d)
                for d in mesh.devices]

    if isinstance(expr, Range):
        return _eval_sharded(And(expr), col, mesh)
    if isinstance(expr, In):
        if not expr.keys:
            return zeros()
        bits, _ = dist.sharded_member_scan(expr.col, np.asarray(expr.keys, np.uint32), mesh)
        return bits
    if isinstance(expr, Not):
        return _complement(_eval_sharded(expr.term, col, mesh), col)
    if isinstance(expr, Or):
        if not expr.terms:
            return zeros()
        spans_by_col, keys_by_col, others = _group_or_terms(expr.terms)
        rows = [_eval_sharded(t, col, mesh) for t in others]
        for c, keys in keys_by_col.values():
            rows.append(_eval_sharded(In(c, keys), col, mesh))
        for c, spans in spans_by_col.values():
            if len(spans) == 1:
                rows.append(_eval_sharded(And(Range(c, *spans[0])), col, mesh))
                continue
            for at in range(0, len(spans), 32):
                g = spans[at : at + 32]
                kbits, _ = dist.sharded_range_scan(
                    c, np.asarray([lo for lo, _ in g], np.uint32),
                    np.asarray([hi for _, hi in g], np.uint32), mesh)
                rows.append([bitvector.logical_or(*b) for b in kbits])
        if not rows:
            return zeros()
        return [bitvector.logical_or(*shard) for shard in zip(*rows)]
    if isinstance(expr, And):
        if not expr.terms:
            return _complement(zeros(), col)
        chunks, others, empty = _group_and_terms(expr.terms)
        if empty:
            return zeros()
        rows = []
        for g in chunks:
            bits, _ = dist.sharded_conj_range_scan(
                [c for c, _, _ in g], np.asarray([lo for _, lo, _ in g], np.uint32),
                np.asarray([hi for _, _, hi in g], np.uint32), mesh)
            rows.append(bits)
        rows.extend(_eval_sharded(t, col, mesh) for t in others)
        return [bitvector.logical_and(*shard) for shard in zip(*rows)]
    raise TypeError(f"not a query expression: {expr!r}")


def evaluate_sharded(expr, mesh) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Evaluate a predicate tree over block-axis-sharded columns -> (bits,
    a list of device-layout int32[B1/S, 128] per shard, still sharded;
    int64 count, all-reduced).  Columns must be sharded identically (the
    same ``dist.shard_column(., mesh)``); ``dist.fetch_global(bits, mesh)``
    gathers the [B1, 128] words, whose first ceil(n/32) are the canonical
    bitvector."""
    from shared_simd_scan_tpu_torch.parallel import dist

    cols = _columns(expr)
    if not cols:
        raise ValueError("query references no columns")
    for c in cols:
        dist._check_column(c, mesh)
    n, b1 = cols[0].n, cols[0].b1
    for c in cols:
        if c.n != n:
            raise ValueError(f"query columns must share n, got {c.n} != {n}")
        if c.b1 != b1:
            raise ValueError("query columns must be sharded identically")
    bits = _eval_sharded(expr, cols[0], mesh)
    return bits, dist._reduce([bitvector.popcount(b) for b in bits], mesh)


def _member_tier_name(keys: tuple, width: int) -> str:
    """The tier :func:`ops.member.member_scan_tiles` dispatches, from the
    dispatcher's own cost rule (:func:`ops.member.member_dispatch_tier`)."""
    arr = np.asarray(keys, np.uint32)
    tier = member_ops.member_dispatch_tier(arr, width)
    if tier == "interval":
        return "member:interval(range-compare)"
    if tier == "window":
        bases, _ = member_ops.member_window_plan(arr)
        return f"member:window-popmask({len(bases)} windows)"
    if tier == "domain":
        return f"member:domain-bitmap({max(1, (1 << width) // 32)} words)"
    if tier == "ortree":
        ops = scan_ops._static_dag_ops(width, arr.tolist(), member=True)
        return f"member:or-tree({ops} DAG ops)"
    return f"member:{'bit-sliced' if tier == 'bitsliced' else 'compare'}"


def explain(expr, indent: str = "", zonemaps: dict | None = None) -> str:
    """Human-readable evaluation plan: which kernel tier each leaf or group
    dispatches to and where bitvectors are combined.  Purely static:
    nothing runs.  The same text as the JAX package's ``explain``; with
    ``zonemaps`` (as :func:`evaluate` takes them) a mapped And also names
    the block rows its pruned pass scans, or its zeros where no zone can
    match."""
    if isinstance(expr, Range):
        return explain(And(expr), indent)
    if isinstance(expr, In):
        if not expr.keys:
            return f"{indent}constant: empty IN -> zeros"
        return (f"{indent}{_member_tier_name(expr.keys, expr.col.width)} "
                f"k={len(expr.keys)} [one pass, one bitvector]")
    if isinstance(expr, Not):
        return (f"{indent}NOT (word-wise complement, tail re-masked)\n"
                + explain(expr.term, indent + "  ", zonemaps))
    if isinstance(expr, (And, Or)):
        op = "AND" if isinstance(expr, And) else "OR"
        lines = [f"{indent}{op} (word-wise combine)"]
        if isinstance(expr, And):
            chunks, others, empty = _group_and_terms(expr.terms)
            if empty:
                return f"{indent}constant: statically empty range intersection -> zeros"
            pruned = ""
            mapped = _mapped_bounds(chunks, zonemaps)
            if mapped:
                span, _ = zonemap.prune_conjunction(mapped)
                if span is None:
                    return f"{indent}constant: no zone admits the mapped ranges -> zeros"
                (start, count), maps = span, len(mapped)
                pruned = (f" over block rows [{start},{start + count}) of {mapped[0][0].b1}, "
                          f"pruned by {maps} zone map{'s' * (maps > 1)}")
            for g in chunks:
                spans = ", ".join(f"[{lo},{hi})" for _, lo, hi in g)
                lines.append(f"{indent}  conj:fused-range m={len(g)} {spans} "
                             f"[one pass over all columns, one bitvector]{pruned}")
            lines.extend(explain(t, indent + "  ", zonemaps) for t in others)
        else:
            spans_by_col, keys_by_col, others = _group_or_terms(expr.terms)
            for col, keys in keys_by_col.values():
                lines.append(f"{indent}  {_member_tier_name(tuple(keys), col.width)} "
                             f"k={len(keys)} [merged In/Eq disjuncts, one pass]")
            for col, spans in spans_by_col.values():
                if len(spans) == 1:
                    lines.append(f"{indent}  conj:fused-range m=1 "
                                 f"[{spans[0][0]},{spans[0][1]}) [one pass]")
                else:
                    lines.append(f"{indent}  range-scan k={len(spans)} ranges on one "
                                 "column [one pass, rows OR'd]")
            lines.extend(explain(t, indent + "  ", zonemaps) for t in others)
        return "\n".join(lines)
    raise TypeError(f"not a query expression: {expr!r}")


__all__ = ["Eq", "Range", "In", "And", "Or", "Not", "evaluate", "evaluate_pruned",
           "evaluate_sharded", "explain"]
