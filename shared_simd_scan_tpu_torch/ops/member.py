"""Fused IN-list (membership) scan: one bitvector for a whole key set.

PyTorch counterpart of ``shared_simd_scan_tpu/ops/member.py``.  The
predicate ``value IN (k_0 .. k_{K-1})`` gives one match row and one count
(duplicate keys count once), not K rows.

Dispatch (:func:`member_scan_tiles`), the JAX package's to the letter:

- host keys (a list, numpy array or CPU tensor) go through
  :func:`member_dispatch_tier`: a consecutive run takes one range compare
  (:func:`ops.scan.range_scan_tiles` with [lo, lo+K)); clustered keys the
  window popmasks (chunked past 32 windows); spread keys the static
  OR-tree tier (on this card one lookup a value in the set's table,
  :func:`member_set_table`); the flat-cost domain bitmap where it is
  cheapest.  Any other tier falls through to the keys path below;
- keys given as a CUDA tensor are runtime keys (the JAX package's traced
  keys) and are never read on the host.  They take the domain bitmap, the
  bit-sliced fold, the compare or the chunked compare by the same cost
  rules (:func:`_member_keys_tiles`).

Each of the JAX package's seven kernel bodies has a wrapper here that
launches a CUDA kernel on CUDA tiles, counts the launch in its own
``launches``, and runs its plain torch version on CPU tiles:

=================================  ===========================================
wrapper (its ``launches``)         CUDA kernel
=================================  ===========================================
``_member_compare_tiles``          ``sss_member_compare`` (``csrc/member.cu``)
``_member_chunked_compare_tiles``  ``sss_member_compare``
``_member_window_tiles``           ``sss_member_window`` (``csrc/member.cu``)
``_member_chunked_window_tiles``   ``sss_member_window``
``_member_domain_tiles``           ``sss_member_domain`` (``csrc/member.cu``)
``_member_ortree_tiles``           ``sss_member_lookup``
                                   (``csrc/member.cu``) on the set's table
``_member_bitsliced_tiles``        ``sss_member_bitsliced``
                                   (``csrc/bitsliced.cu``)
=================================  ===========================================

The TPU tile budgets (``_member_tb``, ``tb_cap``) are not ported: one
thread per 32-value block needs none.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from shared_simd_scan_tpu_torch.bitvector import popcount_words
from shared_simd_scan_tpu_torch.layout import LANES, DeviceColumn, i32, u32
from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.ops.scan import (
    _U32,
    _bitplanes_plain,
    _bounds_tensor,
    _block_values_plain,
    _host_keys,
    _onehot_plain,
    _runtime_keys,
    _static_dag_liveness,
    _static_dag_ops,
    _valid_words,
    bits_to_canonical,
    range_scan_tiles,
    shift_saturates,
)
from shared_simd_scan_tpu_torch.ops.unpack import _check_tiles

# Keys per compare chunk and windows per window chunk of the JAX package's
# kernels; the chunked wrappers keep its padding so their plain versions
# follow its partial rows.
_MAX_COMPARE_KEYS = 32
_MAX_WINDOWS = 32
# Widest column the domain kernel takes: its 2^w-bit table fills 8 KB of
# shared memory per CTA.  The dispatcher sends it widths <= 12 only.  The
# OR-tree tier's lookup takes the same bitmap up to this width, and
# searches the set's windows past it.
MAX_DOMAIN_WIDTH = 16


def member_window_plan(keys) -> tuple[list[int], list[int]]:
    """Concrete keys -> (window bases, window popmasks).

    Windows are the 32-aligned value-domain intervals the keys touch;
    popmask bit j is set iff base + j is in the key set.  Duplicate keys
    merge."""
    arr = np.asarray(keys, dtype=np.uint32)
    pops: dict[int, int] = {}
    for key in arr.tolist():
        base = key // 32 * 32
        pops[base] = pops.get(base, 0) | (1 << (key - base))
    bases = sorted(pops)
    return bases, [pops[b] for b in bases]


def domain_table(keys, width: int) -> torch.Tensor:
    """Key set -> int32[2^width/32, 1] membership bitmap (uint32 bits):
    bit ``v & 31`` of word ``v >> 5`` is set iff v is in the set.  Keys
    whose word lies past the table are dropped; duplicates merge.  A
    tensor of keys stays on its device and is not read on the host."""
    nwords = max(1, (1 << width) // 32)
    if isinstance(keys, torch.Tensor):
        kk = u32(keys.reshape(-1))
    else:
        kk = torch.from_numpy(np.asarray(keys, dtype=np.uint32).astype(np.int64).reshape(-1))
    slot = torch.where(kk < nwords * 32, kk, nwords * 32)  # the extra slot drops a key
    hit = torch.zeros(nwords * 32 + 1, dtype=torch.int64, device=kk.device)
    hit.index_fill_(0, slot, 1)
    shifts = torch.arange(32, dtype=torch.int64, device=kk.device)
    return i32((hit[:-1].reshape(nwords, 32) << shifts).sum(dim=1)).reshape(nwords, 1)


def member_set_table(width: int, patterns) -> torch.Tensor:
    """In-domain keys -> the table ``sss_member_lookup`` reads (int32 on
    the CPU, uint32 bits).  Up to MAX_DOMAIN_WIDTH: the 2^width-bit
    bitmap of :func:`domain_table`, int32[max(1, 2^width/32)].  Past it:
    int32[2, P], the sorted window bases of :func:`member_window_plan`
    padded with 0xFFFFFFFF (above every 32-aligned value) to P, the least
    power of two at or above their count, then their popmasks (0 past the
    windows).  An empty set gives a table that matches nothing."""
    if width <= MAX_DOMAIN_WIDTH:
        return domain_table(list(patterns), width).reshape(-1)
    bases, pops = member_window_plan(list(patterns))
    p = 1 << max(0, len(bases) - 1).bit_length()
    tab = np.zeros((2, p), dtype=np.uint32)
    tab[0] = 0xFFFFFFFF
    tab[0, : len(bases)] = bases
    tab[1, : len(pops)] = pops
    return torch.from_numpy(tab.view(np.int32))


def _domain_member_cost(width: int) -> int:
    """Static cost (quarter-ops-per-value) of the domain-bitmap kernel in
    the JAX package's units: unpack ~14, high-bit predicates 3*(width-5),
    select tree nwords-1, low-bit test ~5.  Flat in k.  Widths past 12 are
    priced out."""
    if width > 12:
        return 1 << 30
    nwords = max(1, (1 << width) // 32)
    return 14 + 4 * (3 * max(0, width - 5) + (nwords - 1) + 5)


# DAG caps of the OR-tree tier: sets past them fall through to the other
# tiers by the dispatch rule.
_ORTREE_MAX_OPS = 4096
_ORTREE_MAX_LIVE = 256


def member_ortree_cost(width: int, arr) -> int:
    """Static cost (quarter-ops-per-value) of the OR-tree member kernel
    for this key set: ~40 fixed (unpack and transpose) plus the counted
    AND/OR/NOT ops of the factored DAG / 8.  DAGs past the ops or
    liveness caps are priced out (1 << 30)."""
    pats = np.asarray(arr, np.uint32).tolist()
    ops = _static_dag_ops(width, pats, member=True)
    if ops > _ORTREE_MAX_OPS:
        return 1 << 30
    if _static_dag_liveness(width, pats, member=True) > _ORTREE_MAX_LIVE:
        return 1 << 30
    return 40 + -(-ops // 8)


def _bitsliced_member_wins(width: int, k: int) -> bool:
    """Bit-sliced fold (48 fixed + (2*width+1)/8 per key) vs the compare
    kernel (~10 per key), in quarter-ops-per-value units."""
    return 48 + (2 * width + 1) * k // 8 < 10 * k


def _consecutive_span(arr: np.ndarray) -> int | None:
    """lo if the concrete keys are exactly the run lo..lo+k-1."""
    if arr.size == 0:
        return None
    lo = int(arr[0])
    return lo if (arr == lo + np.arange(arr.size, dtype=arr.dtype)).all() else None


def member_dispatch_tier(arr, width: int) -> str:
    """The tier :func:`member_scan_tiles` dispatches for host keys:
    'interval' | 'ortree' | 'window' | 'bitsliced' | 'domain' |
    'compare'.  The one home of the dispatch cost rule (OR-tree 40 fixed
    + counted DAG ops / 8, window ~20 per touched window, compare ~10 per
    key, bit-sliced 48 fixed + (2*width+1)/8 per key, domain flat); the
    constants are the JAX package's, kept for dispatch parity."""
    arr = np.asarray(arr, dtype=np.uint32)
    k = int(arr.shape[0])
    if _consecutive_span(arr) is not None:
        return "interval"
    costs = {
        "ortree": member_ortree_cost(width, arr),
        "compare": 10 * k,
        "bitsliced": 48 + (2 * width + 1) * k // 8,
        "domain": _domain_member_cost(width),
    }
    bases, _ = member_window_plan(arr)
    if 20 * len(bases) < min(costs.values()):
        return "window"
    return min(costs, key=costs.get)


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _member_finish(acc: torch.Tensor, n: int, block_offset: int):
    """int64 match words [B1, 128] -> (int32 row, int64 count of the
    masked row)."""
    bits = i32(acc & _valid_words(acc.shape[0], n, block_offset, acc.device))
    return bits, popcount_words(bits).sum()


def _or_rows(rows) -> torch.Tensor:
    """OR of int64 partial rows."""
    out = rows[0]
    for row in rows[1:]:
        out = out | row
    return out


def _compare_row_plain(vals, keys: torch.Tensor) -> torch.Tensor:
    """OR over keys of the equality compares of the 32 values, bit r for
    value r (the compare body)."""
    acc = torch.zeros_like(vals[0])
    for r, v in enumerate(vals):
        hit = torch.zeros_like(v, dtype=torch.bool)
        for j in range(keys.shape[0]):
            hit |= v == keys[j]
        acc |= hit.to(torch.int64) << r
    return acc


def _window_row_plain(vals, win: torch.Tensor) -> torch.Tensor:
    """OR over windows of ``(1 << (v - base)) & popmask != 0``, bit r for
    value r (the window body)."""
    acc = torch.zeros_like(vals[0])
    for r, v in enumerate(vals):
        hit = torch.zeros_like(v, dtype=torch.bool)
        for i in range(win.shape[0]):
            hit |= (_onehot_plain(v, win[i, 0]) & win[i, 1]) != 0
        acc |= hit.to(torch.int64) << r
    return acc


def _launch_one_row(fn_name, tiles, operand, count, width, n, block_offset, *extra):
    """Launch a member kernel that writes one row and one count."""
    b1 = tiles.shape[1]
    device = tiles.device
    bits = torch.empty((b1, LANES), dtype=torch.int32, device=device)
    counts = torch.zeros(1, dtype=torch.int64, device=device)
    _cuda.launch(fn_name, device, tiles.data_ptr(), operand.data_ptr(), count, bits.data_ptr(),
                 counts.data_ptr(), b1 * LANES, width, n, block_offset, *extra)
    return bits, counts[0]


def _check_keys(keys: torch.Tensor, name: str = "keys") -> None:
    if keys.ndim != 1 or keys.shape[0] < 1:
        raise ValueError(f"{name}: expected a non-empty 1-D tensor, got shape {tuple(keys.shape)}")
    _cuda.check_int32(name, keys, (keys.shape[0],))


def _check_win(win: torch.Tensor) -> None:
    if win.ndim != 2 or win.shape[0] < 1:
        raise ValueError(f"win: expected int32[nwin, 2] with nwin >= 1, got {tuple(win.shape)}")
    _cuda.check_int32("win", win, (win.shape[0], 2))


def _check_chunks(rows: int, chunk: int, what: str) -> None:
    if chunk < 1 or rows % chunk:
        raise ValueError(f"{what}: {rows} rows are not whole chunks of {chunk}")


def _member_compare_tiles_plain(tiles, keys, width, n, block_offset=0):
    """Plain version of :func:`_member_compare_tiles`."""
    acc = _compare_row_plain(_block_values_plain(tiles, width), u32(keys))
    return _member_finish(acc, n, block_offset)


def _member_compare_tiles(tiles, keys, width, n, block_offset=0):
    """OR of equality compares against ``keys`` (int32[k], on the tiles'
    device) -> (bits int32[B1, 128], count int64).  Kernel
    ``sss_member_compare``."""
    _check_tiles(tiles, width)
    _check_keys(keys)
    if _cuda.kernel_device(tiles, keys) is None:
        return _member_compare_tiles_plain(tiles, keys, width, n, block_offset)
    out = _launch_one_row("sss_member_compare", tiles, keys, keys.shape[0], width, n,
                          block_offset)
    _member_compare_tiles.launches += 1
    return out


_member_compare_tiles.launches = 0


def _member_chunked_compare_tiles_plain(tiles, keys, width, n, krows, block_offset=0):
    """Plain version of :func:`_member_chunked_compare_tiles`: one partial
    row per chunk of ``krows`` keys, ORed; the count from the final row."""
    vals = _block_values_plain(tiles, width)
    kk = u32(keys)
    rows = [_compare_row_plain(vals, kk[c0 : c0 + krows]) for c0 in range(0, kk.shape[0], krows)]
    return _member_finish(_or_rows(rows), n, block_offset)


def _member_chunked_compare_tiles(tiles, keys, width, n, krows, block_offset=0):
    """:func:`_member_compare_tiles` for a key set of whole chunks of
    ``krows`` keys (padded with 0xFFFFFFFF, which no value equals), as the
    JAX package's chunked compare body takes it.  The kernel walks all the
    keys in one pass: ``sss_member_compare``."""
    _check_tiles(tiles, width)
    _check_keys(keys)
    _check_chunks(keys.shape[0], krows, "keys")
    if _cuda.kernel_device(tiles, keys) is None:
        return _member_chunked_compare_tiles_plain(tiles, keys, width, n, krows, block_offset)
    out = _launch_one_row("sss_member_compare", tiles, keys, keys.shape[0], width, n,
                          block_offset)
    _member_chunked_compare_tiles.launches += 1
    return out


_member_chunked_compare_tiles.launches = 0


def _member_window_tiles_plain(tiles, win, width, n, block_offset=0):
    """Plain version of :func:`_member_window_tiles`."""
    acc = _window_row_plain(_block_values_plain(tiles, width), u32(win))
    return _member_finish(acc, n, block_offset)


def _member_window_tiles(tiles, win, width, n, block_offset=0):
    """Window popmask membership: ``win`` int32[nwin, 2] rows (base,
    popmask), on the tiles' device -> (bits int32[B1, 128], count int64).
    Kernel ``sss_member_window``, with the gateless one-hot iff
    :func:`ops.scan.shift_saturates`."""
    _check_tiles(tiles, width)
    _check_win(win)
    device = _cuda.kernel_device(tiles, win)
    if device is None:
        return _member_window_tiles_plain(tiles, win, width, n, block_offset)
    out = _launch_one_row("sss_member_window", tiles, win, win.shape[0], width, n, block_offset,
                          int(shift_saturates(device)))
    _member_window_tiles.launches += 1
    return out


_member_window_tiles.launches = 0


def _member_chunked_window_tiles_plain(tiles, win, width, n, wrows, block_offset=0):
    """Plain version of :func:`_member_chunked_window_tiles`: one partial
    row per chunk of ``wrows`` windows, ORed; the count from the final
    row."""
    vals = _block_values_plain(tiles, width)
    ww = u32(win)
    rows = [_window_row_plain(vals, ww[c0 : c0 + wrows]) for c0 in range(0, ww.shape[0], wrows)]
    return _member_finish(_or_rows(rows), n, block_offset)


def _member_chunked_window_tiles(tiles, win, width, n, wrows, block_offset=0):
    """:func:`_member_window_tiles` for whole chunks of ``wrows`` windows
    (padded with empty popmasks, which match nothing), as the JAX
    package's chunked window body takes them.  The kernel walks all the
    windows in one pass: ``sss_member_window``."""
    _check_tiles(tiles, width)
    _check_win(win)
    _check_chunks(win.shape[0], wrows, "windows")
    device = _cuda.kernel_device(tiles, win)
    if device is None:
        return _member_chunked_window_tiles_plain(tiles, win, width, n, wrows, block_offset)
    out = _launch_one_row("sss_member_window", tiles, win, win.shape[0], width, n, block_offset,
                          int(shift_saturates(device)))
    _member_chunked_window_tiles.launches += 1
    return out


_member_chunked_window_tiles.launches = 0


def _bitmap_row_plain(vals, table: torch.Tensor) -> torch.Tensor:
    """Bit ``v & 31`` of word ``v >> 5`` of the bitmap, bit r for value r
    (the domain body, and the lookup's bitmap)."""
    tab = u32(table).reshape(-1)
    acc = torch.zeros_like(vals[0])
    for r, v in enumerate(vals):
        acc |= ((tab[v >> 5] >> (v & 31)) & 1) << r
    return acc


def _member_domain_tiles_plain(tiles, keys, width, n, block_offset=0):
    """Plain version of :func:`_member_domain_tiles`: the
    :func:`domain_table` of the keys, then per value bit ``v & 31`` of
    word ``v >> 5``."""
    acc = _bitmap_row_plain(_block_values_plain(tiles, width), domain_table(keys, width))
    return _member_finish(acc, n, block_offset)


def _member_domain_tiles(tiles, keys, width, n, block_offset=0):
    """Domain-bitmap membership for ``keys`` (int32[k], on the tiles'
    device; the table is built from them on the card, so the keys are not
    read on the host) -> (bits int32[B1, 128], count int64).  Widths up to
    MAX_DOMAIN_WIDTH.  Kernel ``sss_member_domain``."""
    _check_tiles(tiles, width)
    _check_keys(keys)
    if width > MAX_DOMAIN_WIDTH:
        raise ValueError(f"the domain kernel takes widths up to {MAX_DOMAIN_WIDTH}, got {width}")
    if _cuda.kernel_device(tiles, keys) is None:
        return _member_domain_tiles_plain(tiles, keys, width, n, block_offset)
    out = _launch_one_row("sss_member_domain", tiles, keys, keys.shape[0], width, n,
                          block_offset)
    _member_domain_tiles.launches += 1
    return out


_member_domain_tiles.launches = 0


def _ortree_patterns(width: int, patterns) -> tuple:
    dom = 1 << width
    return tuple(sorted({int(p) for p in patterns if int(p) < dom}))


def _search_row_plain(vals, table: torch.Tensor) -> torch.Tensor:
    """The search table's lookup, bit r for value r: the last window base
    at or below ``v & ~31``; bit ``v & 31`` of its popmask if it equals it."""
    tab = u32(table)
    bases, pops = tab[0].contiguous(), tab[1]
    acc = torch.zeros_like(vals[0])
    for r, v in enumerate(vals):
        key = v & ~31
        pos = (torch.searchsorted(bases, key, right=True) - 1).clamp(min=0)
        hit = (bases[pos] == key) & (((pops[pos] >> (v & 31)) & 1) == 1)
        acc |= hit.to(torch.int64) << r
    return acc


def _member_ortree_tiles_plain(tiles, width, n, patterns, block_offset=0):
    """Plain version of :func:`_member_ortree_tiles`, same algorithm: one
    lookup a value in the set's :func:`member_set_table`."""
    table = member_set_table(width, _ortree_patterns(width, patterns)).to(tiles.device)
    vals = _block_values_plain(tiles, width)
    row = _bitmap_row_plain if width <= MAX_DOMAIN_WIDTH else _search_row_plain
    return _member_finish(row(vals, table), n, block_offset)


@functools.lru_cache(maxsize=64)
def _member_set_table_on(width: int, patterns: tuple, device: torch.device) -> torch.Tensor:
    """:func:`member_set_table` copied to ``device``, once per set."""
    return member_set_table(width, patterns).to(device)


def _member_ortree_tiles(tiles, width, n, patterns, block_offset=0):
    """Static OR-tree membership for host ``patterns`` (keys >= 2^width
    are dropped, duplicates merge) -> (bits int32[B1, 128], count int64).
    The whole domain gives an all-ones row, an empty set a zero row.

    Kernel ``sss_member_lookup`` (``csrc/member.cu``): one lookup a value
    in the set's :func:`member_set_table`, built on the host and cached
    on the card per width and set."""
    _check_tiles(tiles, width)
    pats = _ortree_patterns(width, patterns)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return _member_ortree_tiles_plain(tiles, width, n, pats, block_offset)
    table = _member_set_table_on(width, pats, device)
    out = _launch_one_row("sss_member_lookup", tiles, table, table.shape[-1], width, n,
                          block_offset)
    _member_ortree_tiles.launches += 1
    return out


_member_ortree_tiles.launches = 0


def _member_bitsliced_tiles_plain(tiles, keys, width, n, krows, block_offset=0):
    """Plain version of :func:`_member_bitsliced_tiles`: per key the plane
    fold ``AND_p(plane_p ^ ((key >> p & 1) - 1))``, killed for keys >=
    2^width; one partial row per chunk of ``krows`` keys, ORed."""
    planes = _bitplanes_plain(tiles, width)
    kk = u32(keys)
    rows = []
    for c0 in range(0, kk.shape[0], krows):
        acc = torch.zeros_like(planes[0])
        for j in range(c0, min(c0 + krows, kk.shape[0])):
            key = kk[j]
            m = torch.where(key < (1 << width), _U32, 0)
            for p, plane in enumerate(planes):
                m = m & (plane ^ ((((key >> p) & 1) - 1) & _U32))
            acc = acc | m
        rows.append(acc)
    return _member_finish(_or_rows(rows), n, block_offset)


def _member_bitsliced_tiles(tiles, keys, width, n, krows, block_offset=0):
    """Bit-sliced membership for ``keys`` (int32[k], whole chunks of
    ``krows``, on the tiles' device; never read on the host) -> (bits
    int32[B1, 128], count int64).  The kernel ORs every key's fold into
    one row in one pass: ``sss_member_bitsliced``."""
    _check_tiles(tiles, width)
    _check_keys(keys)
    _check_chunks(keys.shape[0], krows, "keys")
    if _cuda.kernel_device(tiles, keys) is None:
        return _member_bitsliced_tiles_plain(tiles, keys, width, n, krows, block_offset)
    out = _launch_one_row("sss_member_bitsliced", tiles, keys, keys.shape[0], width, n,
                          block_offset)
    _member_bitsliced_tiles.launches += 1
    return out


_member_bitsliced_tiles.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _pad_keys(keys: torch.Tensor, chunk: int) -> torch.Tensor:
    """Keys padded with 0xFFFFFFFF to whole chunks (on their device)."""
    pad = (-keys.shape[0]) % chunk
    if not pad:
        return keys
    return torch.cat([keys, torch.full((pad,), -1, dtype=torch.int32, device=keys.device)])


def _member_keys_tiles(tiles, keys: torch.Tensor, width: int, n: int, block_offset: int = 0):
    """The keys path of :func:`member_scan_tiles` (the JAX package's
    traced-key rule): ``keys`` int32[k] on the tiles' device, never read on
    the host, take the domain bitmap when its flat cost is below both the
    compare and the bit-sliced cost, else the bit-sliced fold when it
    wins, else the compare kernel (chunked past 32 keys)."""
    k = int(keys.shape[0])
    if _domain_member_cost(width) < min(10 * k, 48 + (2 * width + 1) * k // 8):
        return _member_domain_tiles(tiles, keys, width, n, block_offset)
    if _bitsliced_member_wins(width, k):
        krows = min(k, _MAX_COMPARE_KEYS)
        return _member_bitsliced_tiles(tiles, _pad_keys(keys, krows), width, n, krows,
                                       block_offset)
    if k <= _MAX_COMPARE_KEYS:
        return _member_compare_tiles(tiles, keys, width, n, block_offset)
    return _member_chunked_compare_tiles(tiles, _pad_keys(keys, _MAX_COMPARE_KEYS), width, n,
                                         _MAX_COMPARE_KEYS, block_offset)


def member_scan_tiles(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership scan -> (bits int32[B1, 128], int64 count).

    ``bits.reshape(-1)[:bitvector_words(n)]`` is the canonical LSB-first
    bitvector of ``value in keys``; the count is the number of matching
    values (duplicate keys count once).  Host keys dispatch through
    :func:`member_dispatch_tier`; CUDA-tensor keys are runtime keys and
    take :func:`_member_keys_tiles` without being read on the host."""
    device = tiles.device
    if isinstance(keys, torch.Tensor) and keys.is_cuda:
        keys = _runtime_keys(keys)
        if keys.shape[0] < 1:
            raise ValueError("member scan needs at least one key, got 0")
        return _member_keys_tiles(tiles, keys, width, n, block_offset)
    arr = _host_keys(keys)
    k = int(arr.shape[0])
    if k < 1:
        raise ValueError(f"member scan needs at least one key, got {k}")
    tier = member_dispatch_tier(arr, width)
    if tier == "interval":
        # one unsigned range compare per value, for any k; a run ending at
        # 0xFFFFFFFF has hi = 2^32, which wraps to the span 2^32 - lo
        lo = _consecutive_span(arr)
        bits, counts = range_scan_tiles(tiles, _bounds_tensor([lo], device),
                                        _bounds_tensor([lo + k], device), width, n, block_offset)
        return bits[0], counts[0]
    if tier == "ortree":
        pats = _ortree_patterns(width, arr.tolist())
        if not pats:  # every key out of domain: nothing can match
            return (torch.zeros(tuple(tiles.shape[1:]), dtype=torch.int32, device=device),
                    torch.zeros((), dtype=torch.int64, device=device))
        return _member_ortree_tiles(tiles, width, n, pats, block_offset)
    if tier == "window":
        bases, pops = member_window_plan(arr)
        win = _bounds_tensor(np.stack([bases, pops], axis=1), device).reshape(-1, 2)
        if len(bases) <= _MAX_WINDOWS:
            return _member_window_tiles(tiles, win, width, n, block_offset)
        pad = (-len(bases)) % _MAX_WINDOWS  # empty-popmask windows match nothing
        win = torch.cat([win, torch.zeros((pad, 2), dtype=torch.int32, device=device)])
        return _member_chunked_window_tiles(tiles, win, width, n, _MAX_WINDOWS, block_offset)
    keys_t = _bounds_tensor(arr, device)
    if tier == "domain":
        return _member_domain_tiles(tiles, keys_t, width, n, block_offset)
    return _member_keys_tiles(tiles, keys_t, width, n, block_offset)


def member_scan_device(dev: DeviceColumn, keys) -> tuple[torch.Tensor, torch.Tensor]:
    """IN-list scan on a DeviceColumn -> ((W,) canonical bitvector words,
    int64 match count)."""
    bits, count = member_scan_tiles(dev.tiles, keys, dev.width, dev.n)
    return bits_to_canonical(bits, dev.n), count


__all__ = [
    "member_scan_tiles",
    "member_scan_device",
    "member_window_plan",
    "domain_table",
    "member_dispatch_tier",
]
