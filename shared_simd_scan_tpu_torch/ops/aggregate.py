"""Fused filter + aggregate scans: per-key SUM/COUNT and MIN/MAX over a
measure column, and the masked aggregate over a match bitvector.

PyTorch counterpart of ``shared_simd_scan_tpu/ops/aggregate.py``: the
pushdown ``SELECT key, SUM(m), COUNT(*) FROM t WHERE p IN keys GROUP BY p``
in one pass over two packed columns of the same n (the predicate column
``p`` and the measure column ``m``), its MIN/MAX form, and
``SELECT SUM(m), COUNT(*) WHERE <expr>`` over a bitvector from
``query.evaluate``.

Each of the JAX package's five kernels has a wrapper here that launches a
CUDA kernel on CUDA tiles, counts the launch in ``launches.<wrapper>``
(``utils.profiling``), and runs its plain torch version on CPU tiles:

===================================  ===========================================
wrapper (``launches.<wrapper>``)     CUDA kernel
===================================  ===========================================
``aggregate_scan_tiles``             ``sss_agg_compare`` (``csrc/aggregate.cu``)
``minmax_scan_tiles``                ``sss_minmax_lookup`` (``csrc/agg_lookup.cu``):
                                     a key lookup and three shared updates
                                     a value
``aggregate_bitplane_tiles``         ``sss_agg_device_lookup``
                                     (``csrc/agg_lookup.cu``): the same
                                     for keys in device memory
``aggregate_bitplane_static_tiles``  ``sss_agg_lookup`` (``csrc/agg_lookup.cu``):
                                     a key lookup and scatter-add a value
``masked_aggregate_tiles``           ``sss_masked_agg`` (``csrc/aggregate.cu``)
===================================  ===========================================

Contract.  The reference's ``_tiles`` functions return per-grid-step
int32 partials shaped by the TPU's tile size, finalized on the host.  Here
the ``_tiles`` functions return the finished values as int64 tensors on
the tiles' device, with no host synchronisation: per key (counts, sums)
or (counts, mins, maxs), equal in value to the JAX package's
``finalize_sums`` (uint64) and ``finalize_minmax`` (uint32).  Sums are
exact for any n < 2^32 (n * (2^31 - 1) < 2^63).  An empty group reports
min 2^wm and max 0.

One difference at the edge: the reference's compare and MIN/MAX kernels
rewrite the predicate of padding slots to the sentinel 0xFFFFFFFF, so its
key 0xFFFFFFFF counts every padding slot.  Here, as in the reference's
bit-plane kernels, every match is ANDed with the block's validity word:
the key 0xFFFFFFFF, like every key >= 2^wp, matches nothing in any tier.

Dispatch (:func:`aggregate_scan_device`) is :func:`pick_aggregate_tier`,
the JAX package's rule by counted static cost.  Host keys (a list, numpy
array or CPU tensor) get the exact AND-DAG price; keys given as a CUDA
tensor are runtime keys (the JAX package's traced keys), priced by k
alone and never read on the host.  The TPU tile budgets (``_agg_tb``,
``_agg_bitplane_tb``) are not ported: one thread per 32-value block needs
none.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from shared_simd_scan_tpu_torch.bitvector import popcount_words
from shared_simd_scan_tpu_torch.layout import BLOCK_VALUES, LANES, DeviceColumn, i32, u32
from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.ops.scan import (
    _CountVec,
    _bounds_tensor,
    _check_rows,
    _host_keys,
    _real_values_plain,
    _runtime_keys,
    _static_dag_ops,
    _transpose_bitplanes_plain,
    _valid_words,
)
from shared_simd_scan_tpu_torch.ops.unpack import _check_tiles, unpack_value_plain
from shared_simd_scan_tpu_torch.utils import profiling

MAX_KEYS = 32
# MIN/MAX identities: measure values are < 2^31, so int32 order is exact.
_MIN_ID = 0x7FFFFFFF
_MAX_ID = -1


def _check_k(k: int) -> None:
    if not (1 <= k <= MAX_KEYS):
        raise ValueError(f"aggregate scan supports 1 <= k <= {MAX_KEYS}, got {k}")


def _check_keys(keys: torch.Tensor) -> int:
    if keys.ndim != 1:
        raise ValueError(f"keys: expected a 1-D tensor, got shape {tuple(keys.shape)}")
    k = int(keys.shape[0])
    _check_k(k)
    _cuda.check_int32("keys", keys, (k,))
    return k


def _check_pair(ptiles: torch.Tensor, mtiles: torch.Tensor, wp: int, wm: int) -> int:
    """B1 of two tile sets that must hold columns of the same n."""
    b1 = _check_tiles(ptiles, wp)
    if _check_tiles(mtiles, wm) != b1:
        raise ValueError(f"predicate/measure columns must share n: B1 {b1} vs {mtiles.shape[1]}")
    return b1


def _check_same_n(pdev: DeviceColumn, mdev: DeviceColumn) -> None:
    if pdev.n != mdev.n:
        raise ValueError(f"column lengths differ: predicate n={pdev.n}, measure n={mdev.n}")


def _empty_groups(counts, mins, maxs, wm: int):
    """The empty-group rule: min 2^wm and max 0 where the count is 0."""
    empty = counts == 0
    return torch.where(empty, 1 << wm, mins), torch.where(empty, 0, maxs)


# ---------------------------------------------------------------------------
# Dispatch: counted static costs, copied from the JAX package
# ---------------------------------------------------------------------------
#
# Costs are in the dispatch's quarter-ops-per-value units (ops per 32-value
# word / 8), the convention of scan.bitsliced_cost.  The constants are the
# JAX package's per-32-value vector-op counts of its kernel bodies: unpack
# ~2.5 ops per value per column, select-accumulate ~(1 compare + 2 or 3
# select-add pairs) per key per value, bit-plane ~4 ops per key per measure
# plane word plus the fixed SWAPMOVE transposes.


def _agg_compare_cost(wp: int, wm: int, k: int) -> int:
    nsel = 3 if wm > 16 else 2
    per_value = 7 + k * (1 + 2 * nsel)
    return -(-32 * per_value // 8)


@profiling.watch_cache
@functools.lru_cache(maxsize=64)
def _transpose_ops(width: int) -> int:
    """Counted ops of the liveness-pruned SWAPMOVE transpose to ``width``
    planes: the transpose run on the counting stand-in."""
    ctr = [0]
    _transpose_bitplanes_plain([_CountVec(ctr) for _ in range(BLOCK_VALUES)], width)
    return ctr[0]


def aggregate_bitplane_cost(wp: int, wm: int, keys) -> int:
    """Counted cost of the bit-plane tier for THIS key set: host keys get
    the exact AND-DAG count; an int k prices the runtime XOR fold."""
    unpack = 32 * 5  # both columns, ~2.5 ops/value each
    fixed = unpack + _transpose_ops(wp) + _transpose_ops(wm)
    if isinstance(keys, int):
        k = keys
        match_ops = k * 2 * wp
    else:
        arr = np.asarray(keys, dtype=np.uint32)
        k = int(arr.shape[0])
        match_ops = _static_dag_ops(wp, arr.tolist()) + k  # + valid ANDs
    per_key = 3 + 4 * min(wm, 16) + (4 * (wm - 16) if wm > 16 else 0)
    return -(-(fixed + match_ops + k * per_key) // 8)


def pick_aggregate_tier(wp: int, wm: int, keys) -> str:
    """Dispatch rule of the keyed aggregate: "bitplane" or "compare" by
    counted static cost.  Keys given as a CUDA tensor are priced by k
    alone and not read; host keys get the exact DAG price."""
    if isinstance(keys, torch.Tensor) and keys.is_cuda:
        k = int(keys.shape[0])
        cost_bp = aggregate_bitplane_cost(wp, wm, k)
    else:
        arr = _host_keys(keys)
        k = int(arr.shape[0])
        cost_bp = aggregate_bitplane_cost(wp, wm, arr)
    return "bitplane" if cost_bp < _agg_compare_cost(wp, wm, k) else "compare"


# ---------------------------------------------------------------------------
# Select-accumulate tier: SUM/COUNT; MIN/MAX by key lookup
# ---------------------------------------------------------------------------


def _select_matches(ptiles, mtiles, keys, wp, wm, n, block_offset):
    """Per value slot r: (hit bool [k, B1, 128], measure int64 [B1, 128]),
    hit = predicate == key AND bit r of the validity word."""
    wpw, wmw = u32(ptiles), u32(mtiles)
    kk = u32(keys)[:, None, None]
    valid = _valid_words(ptiles.shape[1], n, block_offset, ptiles.device)
    for r in range(BLOCK_VALUES):
        vbit = ((valid >> r) & 1) == 1
        hit = (unpack_value_plain(wpw, wp, r)[None] == kk) & vbit[None]
        yield hit, unpack_value_plain(wmw, wm, r)


def aggregate_scan_tiles_plain(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys: torch.Tensor, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`aggregate_scan_tiles`, same algorithm:
    per value the predicate compared with every key, masked by the
    validity bit, selecting the measure value into the key's count and
    sum."""
    k = keys.shape[0]
    counts = torch.zeros(k, dtype=torch.int64, device=ptiles.device)
    sums = torch.zeros(k, dtype=torch.int64, device=ptiles.device)
    for hit, m in _select_matches(ptiles, mtiles, keys, wp, wm, n, block_offset):
        counts += hit.sum(dim=(1, 2))
        sums += torch.where(hit, m[None], 0).sum(dim=(1, 2))
    return counts, sums


def aggregate_scan_tiles(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys: torch.Tensor, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-key COUNT and SUM by select-accumulate: ptiles int32[wp, B1,
    128] and mtiles int32[wm, B1, 128] (two columns of ``n`` values), keys
    int32[k <= 32] (uint32 bits), all on one device -> (counts int64[k],
    sums int64[k]).  ``block_offset`` is the global index of the tiles'
    first block, for a shard of longer columns.

    Kernel ``sss_agg_compare`` (``csrc/aggregate.cu``) on CUDA tensors;
    the plain version on CPU tensors."""
    b1 = _check_pair(ptiles, mtiles, wp, wm)
    k = _check_keys(keys)
    device = _cuda.kernel_device(ptiles, mtiles, keys)
    if device is None:
        return aggregate_scan_tiles_plain(ptiles, mtiles, keys, wp, wm, n, block_offset)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    sums = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_agg_compare", device, ptiles.data_ptr(), mtiles.data_ptr(), keys.data_ptr(), k,
        counts.data_ptr(), sums.data_ptr(), b1 * LANES, wp, wm, n, block_offset,
    )
    profiling.count("launches.aggregate_scan_tiles")
    return counts, sums


def _key_slots_plain(ptiles, mtiles, keys, wp, wm, n, block_offset):
    """The key lookup of the kernels on keys in device memory, in torch:
    (slot, measure values, key slots), int64.  A real predicate value's
    slot is the first index of its key among the sorted keys
    (``searchsorted``), slot k for a value that no key holds (padding,
    indices past n); key j's slot is the first index of its value, so a
    duplicate shares its first occurrence's.  The keys are not read on the
    host."""
    k = keys.shape[0]
    pvals, real = _real_values_plain(ptiles, wp, n, block_offset)
    mvals, _ = _real_values_plain(mtiles, wm, n, block_offset)
    table = torch.sort(u32(keys)).values
    pos = torch.searchsorted(table, pvals).clamp_(max=k - 1)
    slot = torch.where(real & (table[pos] == pvals), pos, k).flatten()
    return slot, mvals.flatten(), torch.searchsorted(table, u32(keys))


def minmax_scan_tiles_plain(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys: torch.Tensor, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`minmax_scan_tiles`, same algorithm:
    each real value's slot (:func:`_key_slots_plain`), its count by
    ``bincount`` and its MIN and MAX by ``scatter_reduce_`` (``amin``,
    ``amax`` in int64) into counters that start at the identities
    0x7FFFFFFF and -1; each key reads its slot's, then the empty-group
    rule.  The keys are not read on the host."""
    k = keys.shape[0]
    device = ptiles.device
    slot, mvals, idx = _key_slots_plain(ptiles, mtiles, keys, wp, wm, n, block_offset)
    counts = torch.bincount(slot, minlength=k + 1)
    mins = torch.full((k + 1,), _MIN_ID, dtype=torch.int64, device=device)
    maxs = torch.full((k + 1,), _MAX_ID, dtype=torch.int64, device=device)
    mins.scatter_reduce_(0, slot, mvals, "amin")
    maxs.scatter_reduce_(0, slot, mvals, "amax")
    counts, mins, maxs = counts[idx], mins[idx], maxs[idx]
    return (counts, *_empty_groups(counts, mins, maxs, wm))


def minmax_scan_tiles(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys: torch.Tensor, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-key COUNT, MIN and MAX of the measure column, the arguments of
    :func:`aggregate_scan_tiles` -> (counts, mins, maxs), int64[k] each;
    an empty group has min 2^wm and max 0.  The key values are never read
    on the host, so CUDA-tensor keys stay on the card.

    Kernel ``sss_minmax_lookup`` (``csrc/agg_lookup.cu``: each CTA builds
    a lookup of the keys in shared memory, each real value is looked up
    and its count, MIN and MAX folded into its key's shared counters) on
    CUDA tensors; the plain version on CPU tensors."""
    b1 = _check_pair(ptiles, mtiles, wp, wm)
    k = _check_keys(keys)
    device = _cuda.kernel_device(ptiles, mtiles, keys)
    if device is None:
        return minmax_scan_tiles_plain(ptiles, mtiles, keys, wp, wm, n, block_offset)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    mins = torch.full((k,), _MIN_ID, dtype=torch.int64, device=device)
    maxs = torch.full((k,), _MAX_ID, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_minmax_lookup", device, ptiles.data_ptr(), mtiles.data_ptr(), keys.data_ptr(), k,
        counts.data_ptr(), mins.data_ptr(), maxs.data_ptr(), b1 * LANES, wp, wm, n, block_offset,
    )
    profiling.count("launches.minmax_scan_tiles")
    return (counts, *_empty_groups(counts, mins, maxs, wm))


# ---------------------------------------------------------------------------
# Bit-plane tier: SUM via per-plane popcounts
# ---------------------------------------------------------------------------
#
# SUM over matches decomposes across the measure column's bit planes:
#
#     SUM_j = sum_p 2^p * popcount(match_j & mplane_p)
#
# A block pays a fixed unpack and SWAPMOVE transpose of both columns,
# shared by every key, then ~4 ops per key per measure plane on 32 values
# at once.  On the TPU the match words come from the memoized AND-DAG of
# the static bit-sliced scan (scan._combo) for host keys and from the XOR
# plane fold for runtime keys.  On this card both tiers are one key lookup
# and scatter-add per value (the card has the gather and scatter that
# Mosaic lacks), for host keys and for keys in device memory, with the
# tiers' contract and dispatch price unchanged.


def aggregate_bitplane_tiles_plain(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys: torch.Tensor, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`aggregate_bitplane_tiles`, same
    algorithm: each real value's slot (:func:`_key_slots_plain`), its
    count by ``bincount`` and its measure added to the slot by
    ``index_add_`` in int64 (exact); each key reads its slot's totals (a
    key >= 2^wp, which no value equals, zeros).  The keys are not read on
    the host."""
    k = keys.shape[0]
    slot, mvals, idx = _key_slots_plain(ptiles, mtiles, keys, wp, wm, n, block_offset)
    counts = torch.bincount(slot, minlength=k + 1)
    sums = torch.zeros(k + 1, dtype=torch.int64, device=ptiles.device).index_add_(0, slot, mvals)
    return counts[idx], sums[idx]


def aggregate_bitplane_tiles(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys: torch.Tensor, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-plane aggregate for runtime keys: the contract of
    :func:`aggregate_scan_tiles`; the key values are never read on the
    host, so CUDA-tensor keys stay on the card.

    Kernel ``sss_agg_device_lookup`` (``csrc/agg_lookup.cu``: each CTA
    builds a lookup of the keys in shared memory, each real value is
    looked up and its count and measure added to its key's shared
    counters) on CUDA tensors; the plain version on CPU tensors."""
    b1 = _check_pair(ptiles, mtiles, wp, wm)
    k = _check_keys(keys)
    device = _cuda.kernel_device(ptiles, mtiles, keys)
    if device is None:
        return aggregate_bitplane_tiles_plain(ptiles, mtiles, keys, wp, wm, n, block_offset)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    sums = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_agg_device_lookup", device, ptiles.data_ptr(), mtiles.data_ptr(), keys.data_ptr(),
        k, counts.data_ptr(), sums.data_ptr(), b1 * LANES, wp, wm, n, block_offset,
    )
    profiling.count("launches.aggregate_bitplane_tiles")
    return counts, sums


def _static_keys(keys) -> np.ndarray:
    if isinstance(keys, torch.Tensor) and keys.is_cuda:
        raise TypeError("aggregate_bitplane_static_tiles requires host keys; CUDA-tensor keys "
                        "take aggregate_bitplane_tiles or aggregate_scan_tiles")
    arr = _host_keys(keys)
    _check_k(int(arr.shape[0]))
    return arr


def aggregate_bitplane_static_tiles_plain(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`aggregate_bitplane_static_tiles`, same
    algorithm: each real predicate value's slot among the key set's
    distinct keys by ``searchsorted`` (slot ``len(distinct)`` for the
    rest), its count by ``bincount`` and its measure added to the slot by
    ``index_add_`` in int64 (exact); each key reads its slot's totals, a
    key >= 2^wp none."""
    arr = _static_keys(keys)
    device = ptiles.device
    pvals, real = _real_values_plain(ptiles, wp, n, block_offset)
    mvals, _ = _real_values_plain(mtiles, wm, n, block_offset)
    distinct = np.unique(arr[arr < (1 << wp)])
    none = distinct.size
    table = torch.from_numpy(distinct.astype(np.int64)).to(device)
    slot = torch.full_like(pvals, none)
    if none:
        pos = torch.searchsorted(table, pvals).clamp_(max=none - 1)
        slot = torch.where(real & (table[pos] == pvals), pos, slot)
        del pos
    slot = slot.flatten()
    counts = torch.bincount(slot, minlength=none + 1)
    sums = torch.zeros(none + 1, dtype=torch.int64, device=device).index_add_(0, slot,
                                                                              mvals.flatten())
    counts[none] = sums[none] = 0  # what no key holds: a key >= 2^wp reads these zeros
    idx = torch.from_numpy(np.where(arr < (1 << wp), np.searchsorted(distinct, arr),
                                    none).astype(np.int64)).to(device)
    return counts[idx], sums[idx]


def aggregate_bitplane_static_tiles(
    ptiles: torch.Tensor, mtiles: torch.Tensor, keys, wp: int, wm: int, n: int,
    block_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-plane tier's aggregate for host keys (a list, numpy array or
    CPU tensor; a CUDA tensor raises): the contract of
    :func:`aggregate_scan_tiles`.

    Kernel ``sss_agg_lookup`` (``csrc/agg_lookup.cu``: the keys passed by
    value, each real value looked up among them and its count and measure
    added to its key's shared counters) on CUDA tiles; the plain version on
    CPU tiles."""
    arr = _static_keys(keys)
    b1 = _check_pair(ptiles, mtiles, wp, wm)
    device = _cuda.kernel_device(ptiles, mtiles)
    if device is None:
        return aggregate_bitplane_static_tiles_plain(ptiles, mtiles, arr, wp, wm, n, block_offset)
    host = np.ascontiguousarray(arr, dtype=np.uint32)
    k = int(host.shape[0])
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    sums = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_agg_lookup", device, ptiles.data_ptr(), mtiles.data_ptr(), host.ctypes.data, k,
        counts.data_ptr(), sums.data_ptr(), b1 * LANES, wp, wm, n, block_offset,
    )
    profiling.count("launches.aggregate_bitplane_static_tiles")
    return counts, sums


# ---------------------------------------------------------------------------
# Masked aggregate: SUM/COUNT of the measure over a match bitvector (the
# terminal op of a query-layer predicate tree)
# ---------------------------------------------------------------------------


def masked_aggregate_tiles_plain(
    mtiles: torch.Tensor, bits: torch.Tensor, wm: int, n: int,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`masked_aggregate_tiles`, same
    algorithm: the popcount of each bitvector word and the measure values
    at its set bits, trusting that bits of values at index >= n are zero."""
    if rows is not None:
        start, count = _check_rows(rows, mtiles.shape[1])
        mtiles = mtiles[:, start : start + count]
    bw, wmw = u32(bits), u32(mtiles)
    total = sum(torch.where(((bw >> r) & 1) == 1, unpack_value_plain(wmw, wm, r), 0).sum()
                for r in range(BLOCK_VALUES))
    return popcount_words(bits).sum(), total


def masked_aggregate_tiles(
    mtiles: torch.Tensor, bits: torch.Tensor, wm: int, n: int,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """COUNT and SUM of the measure column over the set bits of a
    device-layout bitvector row ``bits`` int32[B1, 128] (one word per
    block, bits at index >= n zero, as every bitvector of the package has
    them) -> (count, sum), int64 scalars.

    ``rows=(start, count)`` sums block rows start..start+count-1 only (a
    zone map's pruned span, outside which the bits are zero), the measure
    read in place; ``bits`` is then the span's own rows int32[count, 128]
    (:func:`bits_from_canonical` with ``rows``).

    Kernel ``sss_masked_agg`` (``csrc/aggregate.cu``) on CUDA tensors; the
    plain version on CPU tensors."""
    b1 = _check_tiles(mtiles, wm)
    start, nrows = (0, b1) if rows is None else _check_rows(rows, b1)
    _cuda.check_int32("bits", bits, (nrows, LANES))
    device = _cuda.kernel_device(mtiles, bits)
    if device is None:
        return masked_aggregate_tiles_plain(mtiles, bits, wm, n, rows)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    total = torch.zeros(1, dtype=torch.int64, device=device)
    _cuda.launch("sss_masked_agg", device, mtiles.data_ptr() + start * LANES * 4,
                 bits.data_ptr(), count.data_ptr(), total.data_ptr(), nrows * LANES,
                 b1 * LANES, wm)
    profiling.count("launches.masked_aggregate_tiles")
    return count[0], total[0]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def aggregate_scan_device(
    pdev: DeviceColumn, mdev: DeviceColumn, keys
) -> tuple[torch.Tensor, torch.Tensor]:
    """GROUP-BY-key aggregate over two packed columns in one fused pass ->
    (sums int64[k], counts int64[k]) on the columns' device.

    ``sums[j]`` is the exact sum of the measure column over the rows where
    the predicate column equals ``keys[j]``, ``counts[j]`` their number.
    The columns must have the same n.  :func:`pick_aggregate_tier` picks
    the tier: host keys go to the static bit-plane or the compare kernel,
    CUDA-tensor keys (never read on the host) to the runtime bit-plane or
    the compare kernel."""
    _check_same_n(pdev, mdev)
    args = (pdev.tiles, mdev.tiles)
    widths = (pdev.width, mdev.width, pdev.n)
    if isinstance(keys, torch.Tensor) and keys.is_cuda:
        keys = _runtime_keys(keys)
        bitplane = pick_aggregate_tier(pdev.width, mdev.width, keys) == "bitplane"
        fn = aggregate_bitplane_tiles if bitplane else aggregate_scan_tiles
        counts, sums = fn(*args, keys, *widths)
    else:
        arr = _host_keys(keys)
        if pick_aggregate_tier(pdev.width, mdev.width, arr) == "bitplane":
            counts, sums = aggregate_bitplane_static_tiles(*args, arr, *widths)
        else:
            counts, sums = aggregate_scan_tiles(*args, _bounds_tensor(arr, pdev.tiles.device),
                                                *widths)
    return sums, counts


def minmax_scan_device(
    pdev: DeviceColumn, mdev: DeviceColumn, keys
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-key MIN and MAX of the measure column in one fused pass ->
    (mins, maxs, counts), int64[k] each on the columns' device.  Keys may
    be host keys or a CUDA tensor (not read on the host)."""
    _check_same_n(pdev, mdev)
    if isinstance(keys, torch.Tensor) and keys.is_cuda:
        keys = _runtime_keys(keys)
    else:
        keys = _bounds_tensor(_host_keys(keys), pdev.tiles.device)
    counts, mins, maxs = minmax_scan_tiles(pdev.tiles, mdev.tiles, keys, pdev.width, mdev.width,
                                           pdev.n)
    return mins, maxs, counts


def bits_from_canonical(words: torch.Tensor, b1: int,
                        rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Canonical bitvector words -> the device-layout row int32[b1, 128],
    zero-padded (the inverse of scan.bits_to_canonical); with
    ``rows=(start, count)`` the span's rows int32[count, 128] alone, from
    its words only (a view where none is padding)."""
    w = words.reshape(-1)
    if w.dtype != torch.int32:
        w = i32(w.to(torch.int64))
    if w.shape[0] > b1 * LANES:
        raise ValueError(f"{w.shape[0]} bitvector words do not fit {b1} x {LANES} blocks")
    start, count = (0, b1) if rows is None else _check_rows(rows, b1)
    w = w[start * LANES : (start + count) * LANES]
    pad = count * LANES - w.shape[0]
    if pad:
        w = torch.cat([w, torch.zeros(pad, dtype=torch.int32, device=w.device)])
    return w.reshape(count, LANES)


def masked_aggregate_device(
    mdev: DeviceColumn, bits: torch.Tensor, rows: tuple[int, int] | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """SUM and COUNT of a measure column over a match bitvector (canonical
    words, e.g. from ``query.evaluate``) -> (sum, count), int64 scalars on
    the column's device.  ``rows=(start, count)``: a block-row span outside
    which the bits are zero (``query.evaluate_pruned``'s), the only rows
    read; a span of no rows reads nothing and sums to zero.  Span
    ``agg.masked_aggregate_device``."""
    with profiling.span("agg.masked_aggregate_device"):
        if rows is not None and rows[1] == 0:
            zero = torch.zeros(2, dtype=torch.int64, device=mdev.tiles.device)
            return zero[0], zero[1]
        row = bits_from_canonical(bits, mdev.tiles.shape[1], rows)
        count, total = masked_aggregate_tiles(mdev.tiles, row, mdev.width, mdev.n, rows)
        return total, count


__all__ = [
    "aggregate_scan_tiles",
    "aggregate_bitplane_tiles",
    "aggregate_bitplane_static_tiles",
    "aggregate_bitplane_cost",
    "pick_aggregate_tier",
    "aggregate_scan_device",
    "minmax_scan_tiles",
    "minmax_scan_device",
    "masked_aggregate_tiles",
    "masked_aggregate_device",
    "bits_from_canonical",
    "MAX_KEYS",
]
