"""Conjunctive multi-column scan: AND of per-column range predicates.

PyTorch counterpart of ``shared_simd_scan_tpu/ops/conj.py``.  The WHERE
clause ``lo_0 <= a < hi_0 AND lo_1 <= b < hi_1 AND ...`` over m <= 8 packed
columns of the same table runs in one fused pass: each column is read once
and one bitvector and one count are written.  Columns of the same n share
the block layout, so the block of every column lies at the same index.

A column's range is ``(v - lo) < span`` in uint32 arithmetic with
``span = hi - lo if hi > lo else 0``: inverted bounds are an empty range
here, not a wrapped one (unlike :func:`ops.scan.range_scan_tiles`).

:func:`conj_range_scan_tiles` launches ``sss_conj_range_scan``
(``csrc/conj.cu``) on CUDA tiles and counts it in
``launches.conj_range_scan_tiles`` (``utils.profiling``); on CPU tiles
it runs :func:`conj_range_scan_tiles_plain`.  The bounds are host values:
the kernel takes them in its by-value argument.  The kernel reads the
columns through the TMA, so a CUDA column must start on 16 bytes (every
column the port allocates does); the launch raises on one that does not.
"""
from __future__ import annotations

import numpy as np
import torch

from shared_simd_scan_tpu_torch.layout import LANES
from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.ops.scan import (
    _U32,
    _block_values_plain,
    _check_rows,
    _finish,
    _valid_words,
    bits_to_canonical,
)
from shared_simd_scan_tpu_torch.ops.unpack import _check_tiles
from shared_simd_scan_tpu_torch.utils import profiling

MAX_COLUMNS = 8


def _host_bounds(values, name: str, m: int) -> np.ndarray:
    """Host bounds (list, numpy array or CPU tensor) -> uint32[m]."""
    if isinstance(values, torch.Tensor):
        if values.is_cuda:
            raise TypeError(f"{name}: the conjunction kernel takes host bounds, "
                            "not a CUDA tensor")
        values = values.numpy()
    arr = np.asarray(values).reshape(-1)
    if arr.shape[0] != m:
        raise ValueError(f"{name}: expected {m} bounds, got {arr.shape[0]}")
    arr = arr.astype(np.int64)
    if arr.size and (arr.min() < 0 or arr.max() > _U32):
        raise ValueError(f"{name}: bounds must be uint32 values")
    return arr.astype(np.uint32)


def _check_columns(tiles, widths) -> int:
    """Raise unless the columns are 1..MAX_COLUMNS tile arrays of one B1
    on one device; returns B1."""
    m = len(widths)
    if not (1 <= m <= MAX_COLUMNS):
        raise ValueError(f"conj scan supports 1..{MAX_COLUMNS} columns, got {m}")
    if len(tiles) != m:
        raise ValueError(f"{len(tiles)} tile arrays for {m} widths")
    b1s = {_check_tiles(t, w) for t, w in zip(tiles, widths)}
    if len(b1s) != 1:
        raise ValueError("conjunction columns must share n (same B1 block layout)")
    return b1s.pop()


def conj_range_scan_tiles_plain(
    tiles, lows, highs, widths, n: int, block_offset: int = 0,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`conj_range_scan_tiles`, same
    algorithm: per column, bit r = ``(v_r - lo) < span`` (uint32), the
    columns' words ANDed."""
    if rows is not None:
        start, count = _check_rows(rows, tiles[0].shape[1])
        sub, total = conj_range_scan_tiles_plain(
            [t[:, start : start + count] for t in tiles], lows, highs, widths, n,
            block_offset + start * LANES)
        bits = torch.zeros(tuple(tiles[0].shape[1:]), dtype=torch.int32, device=sub.device)
        bits[start : start + count] = sub
        return bits, total
    acc = None
    for t, width, lo, hi in zip(tiles, widths, lows.tolist(), highs.tolist()):
        span = hi - lo if hi > lo else 0
        col = torch.zeros(tuple(t.shape[1:]), dtype=torch.int64, device=t.device)
        for r, v in enumerate(_block_values_plain(t, width)):
            col |= (((v - lo) & _U32) < span).to(torch.int64) << r
        acc = col if acc is None else acc & col
    bits, counts = _finish(acc[None], _valid_words(acc.shape[0], n, block_offset, acc.device))
    return bits[0], counts[0]


def conj_range_scan_tiles(
    tiles, lows, highs, widths, n: int, block_offset: int = 0,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """AND of m half-open ranges [lo_c, hi_c), one per column, fused.

    ``tiles`` are m tile arrays int32[width_c, B1, 128] (same B1, one
    device); ``lows``/``highs`` are m host uint32 values.  Returns (bits
    int32[B1, 128], count int64) with the bitvector contract of
    :func:`ops.scan.shared_scan_tiles` (LSB-first, padding masked).

    ``rows=(start, count)`` scans block rows start..start+count-1 only (a
    zone map's pruned span), with the contract of
    :func:`ops.scan.range_scan_tiles`: the span is read in place and its
    bits land at their rows of an otherwise zero full-length row.

    Kernel ``sss_conj_range_scan`` (``csrc/conj.cu``) on CUDA tiles; the
    plain version on CPU tiles."""
    tiles, widths = tuple(tiles), tuple(int(w) for w in widths)
    b1 = _check_columns(tiles, widths)
    start, count = (0, b1) if rows is None else _check_rows(rows, b1)
    lo = _host_bounds(lows, "lows", len(widths))
    hi = _host_bounds(highs, "highs", len(widths))
    device = _cuda.kernel_device(*tiles)
    if device is None:
        return conj_range_scan_tiles_plain(tiles, lo, hi, widths, n, block_offset, rows)
    alloc = torch.empty if count == b1 else torch.zeros
    bits = alloc((b1, LANES), dtype=torch.int32, device=device)
    counts = torch.zeros(1, dtype=torch.int64, device=device)
    skip = start * LANES * 4  # bytes before the first scanned block of a row
    ptrs = np.asarray([t.data_ptr() + skip for t in tiles], dtype=np.int64)
    wid = np.asarray(widths, dtype=np.int32)
    _cuda.launch(
        "sss_conj_range_scan", device, ptrs.ctypes.data, wid.ctypes.data, lo.ctypes.data,
        hi.ctypes.data, len(widths), bits.data_ptr() + skip, counts.data_ptr(), count * LANES,
        b1 * LANES, n, block_offset + start * LANES,
    )
    profiling.count("launches.conj_range_scan_tiles")
    return bits, counts[0]


def conj_range_scan_device(devs, lows, highs, rows: tuple[int, int] | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conjunction of range predicates over same-table DeviceColumns ->
    ((W,) canonical bitvector words, int64 match count); ``rows`` as
    :func:`conj_range_scan_tiles` takes it.  Span
    ``conj.conj_range_scan_device``."""
    with profiling.span("conj.conj_range_scan_device"):
        devs = list(devs)
        n = devs[0].n
        for d in devs:
            if d.n != n:
                raise ValueError(f"conjunction columns must share n, got {d.n} != {n}")
        bits, count = conj_range_scan_tiles(
            tuple(d.tiles for d in devs), lows, highs, tuple(d.width for d in devs), n,
            rows=rows,
        )
        return bits_to_canonical(bits, n), count


def conj_eq_scan_device(devs, keys) -> tuple[torch.Tensor, torch.Tensor]:
    """Conjunction of equality predicates (one key per column): the
    degenerate ranges [key_c, key_c + 1), with key + 1 in uint32 as the
    JAX package computes it (0xFFFFFFFF + 1 wraps to an empty range)."""
    devs = list(devs)
    keys = _host_bounds(keys, "keys", len(devs))
    return conj_range_scan_device(devs, keys, keys + np.uint32(1))


__all__ = [
    "conj_range_scan_tiles",
    "conj_range_scan_device",
    "conj_eq_scan_device",
]
