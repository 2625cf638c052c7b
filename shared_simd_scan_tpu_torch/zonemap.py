"""Zone maps: per-block-range min/max statistics and pruned scans.

PyTorch counterpart of ``shared_simd_scan_tpu/zonemap.py``.  Record the
min/max of each fixed range of rows (a zone), then answer a range or
equality predicate by scanning only the blocks whose zones can hold a
match: on a sorted or time-clustered column a point query touches O(1)
zones, as Netezza zone maps and Parquet column-chunk statistics do.

- :class:`ZoneMap` has the JAX package's fields (``zone_b1``, ``b1`` and
  numpy uint32 ``zmin``/``zmax``), so a zone map built by either package
  serves the other as it is.
- :func:`pruned_range_scan` scans the one contiguous block-row span that
  :func:`prune_span` finds, in place (``ops.scan.range_scan_tiles`` with
  ``rows``), or the whole column when the span exceeds half of it.
- :func:`prune_conjunction` intersects the spans of an AND's mapped
  columns (:func:`intersect_spans`), for the planner's one fused pass over
  the intersection (``query.evaluate_pruned``).
- :func:`zoned_range_scan` scans the live steps of :func:`zone_step_mask`
  only (:func:`zoned_range_tiles`, kernel ``sss_zoned_range_scan``: one
  call that writes the whole row, or with ``full_bits=False`` counts the
  live steps and writes no row), or the whole column when half the steps
  or more are live.

Padding positions are left out of the zone statistics (the scan kernels
mask them out of results the same way), so an all-padding zone reports
(0xFFFFFFFF, 0) and never matches.  Results: canonical bitvector words
int32[ceil(n/32)] and an int64 count on the column's device; the JAX
package's uint32 count has the same value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shared_simd_scan_tpu_torch.layout import (
    BLOCK_VALUES,
    LANES,
    DeviceColumn,
    bitvector_words,
)
from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.ops.scan import (
    MAX_LAUNCH_KEYS,
    _bounds_tensor,
    _check_key_tensor,
    bits_to_canonical,
    range_scan_tiles,
    range_scan_tiles_plain,
)
from shared_simd_scan_tpu_torch.ops.unpack import _check_tiles, unpack_tiles
from shared_simd_scan_tpu_torch.utils import profiling

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ZoneMap:
    """Per-zone min/max over ``zone_b1`` device-block rows
    (= zone_b1 * 128 blocks = zone_b1 * 4096 values per zone)."""

    zone_b1: int
    b1: int
    zmin: np.ndarray  # (nz,) uint32; 0xFFFFFFFF for all-padding zones
    zmax: np.ndarray  # (nz,) uint32; 0 for all-padding zones

    @property
    def nzones(self) -> int:
        return self.zmin.shape[0]


def _check_zone_b1(zone_b1: int, b1: int) -> None:
    if zone_b1 % 8 or b1 % zone_b1:
        raise ValueError(
            f"zone_b1={zone_b1} must be a multiple of 8 dividing the "
            f"padded block-row count {b1} (8/64 always work)"
        )


def build_zonemap(dev: DeviceColumn, zone_b1: int = 64, chunk_zones: int = 64) -> ZoneMap:
    """One decompress pass -> ZoneMap: the unpack kernel on chunks of
    ``chunk_zones`` zones (so the unpacked values stay tens of MB), then
    min/max of each zone's real values.  Padding positions count as
    0xFFFFFFFF for the min and 0 for the max, so all-padding zones prune
    away.  Every chunk is reduced on the device; the statistics are copied
    to the host once."""
    width, n = dev.width, dev.n
    b1 = dev.tiles.shape[1]
    _check_zone_b1(zone_b1, b1)
    device = dev.tiles.device
    full, rem = n // BLOCK_VALUES, n % BLOCK_VALUES
    r = torch.arange(BLOCK_VALUES, device=device)[:, None, None]
    lane = torch.arange(LANES, device=device)[None, :]
    mins, maxs = [], []
    step = chunk_zones * zone_b1
    for s in range(0, b1, step):
        rows = min(step, b1 - s)
        # values < 2^31 (width <= 31): the int32 words widen to int64 as they are
        vals = unpack_tiles(dev.tiles[:, s : s + rows].contiguous(), width).to(torch.int64)
        blk = (s + torch.arange(rows, device=device)[:, None]) * LANES + lane
        valid = (blk < full) | ((blk == full) & (r < rem))
        shape = (BLOCK_VALUES, rows // zone_b1, zone_b1, LANES)
        mins.append(torch.where(valid, vals, _U32).reshape(shape).amin(dim=(0, 2, 3)))
        maxs.append(torch.where(valid, vals, 0).reshape(shape).amax(dim=(0, 2, 3)))
    stats = torch.stack([torch.cat(mins), torch.cat(maxs)]).cpu().numpy().astype(np.uint32)
    return ZoneMap(zone_b1=zone_b1, b1=b1, zmin=stats[0], zmax=stats[1])


def build_zonemap_from_values(values: np.ndarray, b1: int, zone_b1: int = 64) -> ZoneMap:
    """Ingest-time zone map: numpy min/max over the values before packing
    (:func:`build_zonemap` serves columns whose raw values are gone).

    ``b1`` is the packed column's padded block-row count
    (``dev.tiles.shape[1]``); value index i lands in zone
    ``i // (zone_b1 * 4096)`` under the device layout, so plain contiguous
    reduction is exact."""
    _check_zone_b1(zone_b1, b1)
    values = np.asarray(values, dtype=np.uint32)
    per = zone_b1 * LANES * BLOCK_VALUES
    nz = b1 // zone_b1
    zmin = np.full(nz, 0xFFFFFFFF, np.uint32)
    zmax = np.zeros(nz, np.uint32)
    # padding positions never match any predicate, so zone stats cover real
    # values only, as build_zonemap's validity-masked reduction does
    for z in range(0, (values.size + per - 1) // per):
        chunk = values[z * per : (z + 1) * per]
        zmin[z] = chunk.min()
        zmax[z] = chunk.max()
    return ZoneMap(zone_b1=zone_b1, b1=b1, zmin=zmin, zmax=zmax)


def _zone_hits(zmap: ZoneMap, lo: int, hi: int) -> np.ndarray:
    return (zmap.zmax.astype(np.uint64) >= lo) & (zmap.zmin.astype(np.uint64) < hi)


def prune_span(zmap: ZoneMap, lo: int, hi: int) -> tuple[int, int] | None:
    """Bucketed block-row span (start, span) covering every zone that can
    contain a value in [lo, hi); None when no zone can match.  start is
    8-aligned and span is a power of two >= 8 (clamped to the column), as
    in the JAX package, whose span is a compiled shape."""
    return _hit_span(zmap, np.flatnonzero(_zone_hits(zmap, lo, hi)))


def _hit_span(zmap: ZoneMap, zones: np.ndarray) -> tuple[int, int] | None:
    """:func:`prune_span` of the zones listed in ``zones`` (ascending)."""
    if not zones.size:
        return None
    zf, zl = int(zones[0]), int(zones[-1])
    s = (zf * zmap.zone_b1) // 8 * 8
    need = (zl + 1) * zmap.zone_b1 - s
    span = 8
    while span < need:
        span *= 2
    if span >= zmap.b1:
        return (0, zmap.b1)
    if s + span > zmap.b1:
        s = zmap.b1 - span
    return (s, span)


def _admitted_rows(hits: list[tuple[ZoneMap, np.ndarray]], start: int, stop: int) -> int:
    """Block rows in [start, stop) of the zones that every (zone map, its
    listed zones) admits; [start, stop) holds the spans' intersection,
    so a lone map's span holds all its zones.  Spans and zones start at
    multiples of 8 block rows."""
    if len(hits) == 1:
        zmap, zones = hits[0]
        return zones.size * zmap.zone_b1
    live = None
    for zmap, zones in hits:
        hit = np.zeros(zmap.nzones, bool)
        hit[zones] = True
        rows = np.repeat(hit, zmap.zone_b1 // 8)
        live = rows if live is None else live & rows
    return 8 * int(live[start // 8 : stop // 8].sum())


def intersect_spans(spans) -> tuple[int, int] | None:
    """The block rows that every span (start, count) holds, as one span;
    None where they do not meet."""
    start = max(s for s, _ in spans)
    stop = min(s + c for s, c in spans)
    return (start, stop - start) if stop > start else None


def prune_conjunction(bounds) -> tuple[tuple[int, int] | None, int]:
    """The AND of ranges on mapped columns of one table, ``bounds`` a list
    of (ZoneMap, lo, hi) -> (the block-row span left to scan: the
    intersection of every column's :func:`prune_span`, None where a column
    has no zone that can match or the spans do not meet; the block rows,
    inside that span, of the zones that every column admits, 0 with
    None)."""
    b1s = {zmap.b1 for zmap, _, _ in bounds}
    if len(b1s) != 1:
        raise ValueError(f"zone maps of one conjunction must share b1, got {sorted(b1s)}")
    hits, spans = [], []
    for zmap, lo, hi in bounds:
        zones = np.flatnonzero(_zone_hits(zmap, lo, hi))
        sp = _hit_span(zmap, zones)
        if sp is None:
            return None, 0
        hits.append((zmap, zones))
        spans.append(sp)
    span = intersect_spans(spans)
    if span is None:
        return None, 0
    return span, _admitted_rows(hits, span[0], span[0] + span[1])


def _no_match(dev: DeviceColumn, full_bits: bool):
    device = dev.tiles.device
    bits = torch.zeros(bitvector_words(dev.n), dtype=torch.int32, device=device) \
        if full_bits else None
    return bits, torch.zeros((), dtype=torch.int64, device=device)


def _range_bounds(lo: int, hi: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return _bounds_tensor([int(lo)], device), _bounds_tensor([int(hi)], device)


def pruned_range_scan(
    dev: DeviceColumn, zmap: ZoneMap, lo: int, hi: int, full_bits: bool = True
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Range scan [lo, hi) over the pruned block-row span only ->
    (canonical bitvector words (W,) when ``full_bits`` else None, int64
    count).

    Dispatch, as the JAX package's: no overlapping zone -> an all-zero
    result and no launch; a span over half the column -> the full-column
    range kernel; else the range kernel on the span's rows, in place.
    Span ``zonemap.pruned_range_scan``; counters
    ``zonemap.block_rows_scanned`` (block rows the kernel reads),
    ``zonemap.block_rows_admitted`` (those of the zones the map admits) and
    ``zonemap.pruned_empty`` (a prune that launched nothing)."""
    with profiling.span("zonemap.pruned_range_scan"):
        b1 = dev.tiles.shape[1]
        zones = np.flatnonzero(_zone_hits(zmap, lo, hi))
        sp = _hit_span(zmap, zones)
        if sp is None:
            profiling.count("zonemap.pruned_empty")
            return _no_match(dev, full_bits)
        start, span = sp
        rows = None if span * 2 > b1 else (start, span)
        profiling.count("zonemap.block_rows_scanned", b1 if rows is None else span)
        profiling.count("zonemap.block_rows_admitted", _admitted_rows([(zmap, zones)], 0, b1))
        lows, highs = _range_bounds(lo, hi, dev.tiles.device)
        bits, counts = range_scan_tiles(dev.tiles, lows, highs, dev.width, dev.n, rows=rows)
        return (bits_to_canonical(bits, dev.n)[0] if full_bits else None), counts[0]


def pruned_eq_scan(dev: DeviceColumn, zmap: ZoneMap, key: int, full_bits: bool = True):
    """Equality scan via the zone map: range [key, key+1)."""
    return pruned_range_scan(dev, zmap, int(key), int(key) + 1, full_bits=full_bits)


# ---------------------------------------------------------------------------
# Per-step gating: the zoned scan
# ---------------------------------------------------------------------------
#
# prune_span covers one contiguous span, so a clustered but unsorted column
# (matching zones scattered through it) degrades to a full scan.  The zoned
# scan skips every dead step of tb block rows on its own: its kernel runs on
# a list of live steps only, and their blocks alone are read.


def _pick_tb(b1: int, tb: int | None) -> int:
    """The JAX package's step rule (``ops/unpack.py`` ``_pick_tb``): the
    largest multiple of 8 <= tb (default 128) dividing b1.  Here it only
    sets the zoned scan's step granularity, and with it where the zoned
    scan falls back to the full kernel; no kernel's tile size comes from it."""
    tb = tb or 128
    tb = max((tb // 8) * 8, 8)
    while b1 % tb:
        tb -= 8
    return tb


def zone_step_mask(zmap: ZoneMap, lo: int, hi: int, tb: int) -> np.ndarray:
    """Per-tb-step liveness: step s (block rows [s*tb, (s+1)*tb)) is live
    iff any overlapping zone intersects [lo, hi).  A prefix sum of the zone
    hits, read at each step's first and last zone (clipped to the zones
    there are, as a slice is)."""
    hit = _zone_hits(zmap, lo, hi)
    if zmap.b1 % tb:
        # floor division would silently drop the tail block rows from the
        # mask and prune live data
        raise ValueError(f"tb={tb} must divide b1={zmap.b1}")
    starts = np.arange(zmap.b1 // tb, dtype=np.int64) * tb
    zf = np.minimum(starts // zmap.zone_b1, hit.size)
    zl = np.minimum((starts + tb - 1) // zmap.zone_b1 + 1, hit.size)
    seen = np.concatenate([[0], np.cumsum(hit, dtype=np.int64)])
    return seen[zl] > seen[zf]


def _check_steps(idx: torch.Tensor, flag: torch.Tensor, tb: int, b1: int) -> int:
    if idx.ndim != 1 or idx.shape[0] < 1:
        raise ValueError(f"idx: expected a non-empty 1-D tensor, got shape {tuple(idx.shape)}")
    _cuda.check_int32("idx", idx, tuple(idx.shape))
    _cuda.check_int32("flag", flag, tuple(idx.shape))
    if tb < 1 or b1 % tb:
        raise ValueError(f"tb={tb} must divide b1={b1}")
    return int(idx.shape[0])


def zoned_range_tiles_plain(
    tiles: torch.Tensor, idx: torch.Tensor, flag: torch.Tensor, lows: torch.Tensor,
    highs: torch.Tensor, width: int, n: int, tb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`zoned_range_tiles`: the range scan of
    each listed step's block rows, its bits in place; a step with flag 0
    writes its bits and adds no count."""
    bits = torch.zeros((lows.shape[0],) + tuple(tiles.shape[1:]), dtype=torch.int32,
                       device=tiles.device)
    counts = torch.zeros(lows.shape[0], dtype=torch.int64, device=tiles.device)
    for s, f in zip(idx.tolist(), flag.tolist()):
        rows = slice(s * tb, (s + 1) * tb)
        bits[:, rows], c = range_scan_tiles_plain(tiles[:, rows], lows, highs, width, n,
                                                  s * tb * LANES)
        if f == 1:
            counts += c
    return bits, counts


def zoned_range_tiles(
    tiles: torch.Tensor, idx: torch.Tensor, flag: torch.Tensor, lows: torch.Tensor,
    highs: torch.Tensor, width: int, n: int, tb: int, full_bits: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """k range predicates over the listed steps of tb block rows only ->
    (bits int32[k, B1, 128], or None when not ``full_bits``; counts
    int64[k]): idx and flag int32[g] on the tiles' device; entry s scans
    step idx[s] and counts it iff flag[s] is 1 (the JAX package pads its
    list with flag-0 repeats of a live step; the port's own caller lists
    live steps only).  Blocks of unlisted steps are not read and their bits
    are zero.

    Kernel ``sss_zoned_range_scan`` (``csrc/zoned.cu``) on CUDA tensors:
    one call that writes every word of the rows (allocated with
    ``torch.empty``; the C entry zeroes them and the counts on the stream,
    then launches the listed steps' grid), or without ``full_bits`` its
    count form, which reads the listed steps and writes no row.  The plain
    version on CPU tensors."""
    b1 = _check_tiles(tiles, width)
    _check_key_tensor(lows)
    _cuda.check_int32("highs", highs, tuple(lows.shape))
    g = _check_steps(idx, flag, tb, b1)
    k = int(lows.shape[0])
    if k > MAX_LAUNCH_KEYS:
        raise ValueError(f"zoned range scan takes at most {MAX_LAUNCH_KEYS} ranges, got {k}")
    device = _cuda.kernel_device(tiles, idx, flag, lows, highs)
    if device is None:
        bits, counts = zoned_range_tiles_plain(tiles, idx, flag, lows, highs, width, n, tb)
        return (bits if full_bits else None), counts
    bits = torch.empty((k, b1, LANES), dtype=torch.int32, device=device) if full_bits else None
    counts = torch.empty(k, dtype=torch.int64, device=device)  # zeroed by the C entry
    _cuda.launch(
        "sss_zoned_range_scan", device, tiles.data_ptr(), idx.data_ptr(), flag.data_ptr(), g,
        lows.data_ptr(), highs.data_ptr(), k, None if bits is None else bits.data_ptr(),
        counts.data_ptr(), b1 * LANES, tb * LANES, width, n,
    )
    profiling.count("launches.zoned_range_tiles")
    return bits, counts


def zoned_range_scan(
    dev: DeviceColumn, zmap: ZoneMap, lo: int, hi: int, tb: int | None = None,
    full_bits: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Range scan [lo, hi) with per-step zone gating -> (canonical
    bitvector words (W,) when ``full_bits`` else None, int64 count).

    Unlike :func:`pruned_range_scan` this skips every dead step of ``tb``
    block rows (default 256, as :func:`_pick_tb` fits it to b1) on its
    own, so a clustered but unsorted column keeps its skipping.  Dispatch,
    as the JAX package's: no live step -> an all-zero result and no
    launch; half the steps or more live -> the full-column range kernel;
    else :func:`zoned_range_tiles` on the live steps (its count form when
    not ``full_bits``)."""
    b1 = dev.tiles.shape[1]
    tb = _pick_tb(b1, tb if tb is not None else 256)
    live = zone_step_mask(zmap, lo, hi, tb)
    nlive = int(live.sum())
    if nlive == 0:
        return _no_match(dev, full_bits)
    device = dev.tiles.device
    lows, highs = _range_bounds(lo, hi, device)
    if 2 * nlive >= live.shape[0]:
        bits, counts = range_scan_tiles(dev.tiles, lows, highs, dev.width, dev.n)
    else:
        idx = torch.from_numpy(np.nonzero(live)[0].astype(np.int32)).to(device)
        flag = torch.ones(nlive, dtype=torch.int32, device=device)
        bits, counts = zoned_range_tiles(dev.tiles, idx, flag, lows, highs, dev.width, dev.n, tb,
                                         full_bits)
    return (bits_to_canonical(bits, dev.n)[0] if full_bits else None), counts[0]


def zoned_eq_scan(dev: DeviceColumn, zmap: ZoneMap, key: int, tb: int | None = None,
                  full_bits: bool = True):
    """Equality scan with per-step zone gating: range [key, key+1)."""
    return zoned_range_scan(dev, zmap, int(key), int(key) + 1, tb=tb, full_bits=full_bits)


__all__ = [
    "ZoneMap",
    "build_zonemap",
    "build_zonemap_from_values",
    "prune_span",
    "intersect_spans",
    "prune_conjunction",
    "zone_step_mask",
    "pruned_range_scan",
    "pruned_eq_scan",
    "zoned_range_tiles",
    "zoned_range_scan",
    "zoned_eq_scan",
]
