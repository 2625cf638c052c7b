"""Fused shared scans on the tile layout, and the shared scan's route.

PyTorch counterpart of the shared-scan part of
``shared_simd_scan_tpu/ops/scan.py``.  One wrapper a row of the JAX
package's kernels:

- the compare kernel (:func:`shared_scan_tiles`, the route's entry);
- the chunked scan and the dynamic scan, a key lookup per value for any k
  (:func:`shared_scan_chunked_tiles`, :func:`shared_scan_dynamic_tiles`);
- the interval kernel for consecutive keys (:func:`interval_scan_tiles`)
  with its shift canary (:func:`shift_saturates`);
- the bit-sliced rows as the plane fold in tile order: on a key tensor
  (:func:`shared_scan_bitsliced_tiles`) and on host keys copied to the
  card (:func:`shared_scan_bitsliced_static_tiles`);
- the windowed row as one lookup a value in the host keys' window tables
  (:func:`windowed_scan_tiles`);
- the range scan, k half-open ranges in one pass (:func:`range_scan_tiles`);
- the member OR-tree DAG (:func:`_member_or_tree`) and its cost and
  liveness counters, which ``ops/member.py`` dispatches on;
- the value histogram without bitvectors: the runtime-lo bins kernel
  (:func:`histogram_tiles`); for a host lo the static fold's counts form or
  the bins kernel's span form (:func:`histogram_dag_tiles`); and their
  dispatcher :func:`histogram_device`.
- the linear export: the interval, static and runtime-key scans fused
  with the byte interleave (:func:`interval_scan_linear_words_tiles`,
  :func:`static_scan_linear_words_tiles`,
  :func:`bitsliced_scan_linear_words_tiles` and their ``_large`` forms) and
  the dispatchers :func:`shared_scan_linear_words_device` and
  :func:`shared_scan_linear_device` (the interleave itself is in
  ``ops/linear.py``).

The shared scan's route (:func:`shared_scan_device`, and
``parallel/dist.py`` ``sharded_shared_scan``): a host run of 2..1024
consecutive keys takes the interval kernel; every other key set, host keys
copied to the card once a set or keys given as a CUDA tensor, goes to
:func:`_routed_scan` (:func:`shared_scan_tiles` for a key tensor), which
launches each MAX_LAUNCH_KEYS keys on the kernel :func:`pick_route` reads
from H100 sweeps of ``bench/redesign_sweep.py``.  By ``compare``, the
compare kernel for fewer than 4 keys at widths 9 and 12 (2 at width 5, 8
at widths 16-20, 16 at 25 and 31; none at width 1), else the plane fold;
by ``runtime``, in place of the fold the dynamic scan's lookup at widths
10-12 from 192 or 256 keys and at widths 20-31 from 128 to 1024 keys, by
width; by ``windowed``, for host keys in place of that lookup the window
lookup on the keys' tables at widths 20-31 and 1024 keys.  The wrappers of
the bit-sliced and windowed rows launch their own kernel and no
dispatcher picks them.

Output contract (the JAX package's): ``bits[k, B1, 128]`` holds one
LSB-first uint32 word per block and key, with bits of values at index
``>= n`` zero, so ``bits[j].reshape(-1)[:bitvector_words(n)]`` is key j's
canonical bitvector; counts are int64 and equal the JAX package's uint32
counts.

Each kernel wrapper launches its CUDA kernel (``csrc/*.cu``) on CUDA
tensors and runs the plain torch version beside it on CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from shared_simd_scan_tpu_torch.bitvector import popcount_words
from shared_simd_scan_tpu_torch.layout import (
    BLOCK_VALUES,
    LANES,
    DeviceColumn,
    bitvector_words,
    i32,
    u32,
    unpack_schedule,
)
from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.ops.unpack import _check_tiles, unpack_value_plain
from shared_simd_scan_tpu_torch.utils import profiling

MAX_INTERVAL_KEYS = 1024
# Key rows per kernel launch: the size of the kernels' per-CTA shared
# counters (kMaxKeys in csrc/common.cuh).  Wrappers split larger key sets.
MAX_LAUNCH_KEYS = 1024
_U32 = 0xFFFFFFFF


def _valid_words(b1: int, n: int, block_offset: int, device) -> torch.Tensor:
    """int64 [B1, 128]: bits of each block that hold values with index < n
    (global block id block_offset + b), so key 0 never matches padding."""
    full, rem = n // BLOCK_VALUES, n % BLOCK_VALUES
    g = block_offset + torch.arange(b1 * LANES, dtype=torch.int64, device=device)
    tail = (1 << rem) - 1 if rem else 0
    valid = torch.where(g < full, _U32, torch.where(g == full, tail, 0))
    return valid.reshape(b1, LANES)


def _finish(words: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 per-key words [k, B1, 128] -> (int32 bits, int64 counts [k])."""
    bits = i32(words & valid)
    return bits, popcount_words(bits).sum(dim=(1, 2))


def _block_values_plain(tiles: torch.Tensor, width: int) -> list[torch.Tensor]:
    """The 32 values of every block, as int64 tensors [B1, 128]."""
    w = u32(tiles)
    return [unpack_value_plain(w, width, r) for r in range(BLOCK_VALUES)]


def _check_key_tensor(keys: torch.Tensor) -> None:
    if keys.ndim != 1 or keys.shape[0] < 1:
        raise ValueError(f"keys: expected a non-empty 1-D tensor, got shape {tuple(keys.shape)}")
    _cuda.check_int32("keys", keys, (keys.shape[0],))


def _host_keys(keys) -> np.ndarray:
    """Keys as a host uint32 array (a CUDA tensor is copied to the host)."""
    if isinstance(keys, torch.Tensor):
        keys = keys.detach().cpu().numpy()
    return np.asarray(keys, dtype=np.uint32).reshape(-1)


def _concrete_keys(keys, name: str) -> np.ndarray:
    """Host keys of a tier whose plan is built from the key values."""
    if isinstance(keys, torch.Tensor) and keys.is_cuda:
        raise TypeError(f"{name} requires host keys; CUDA-tensor keys take "
                        "shared_scan_bitsliced_tiles or shared_scan_tiles")
    arr = _host_keys(keys)
    if arr.shape[0] < 1:
        raise ValueError(f"{name} needs at least one key, got 0")
    return arr


# ---------------------------------------------------------------------------
# General compare tier
# ---------------------------------------------------------------------------


def shared_scan_tiles_plain(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`shared_scan_tiles`, same algorithm:
    clean-mask compare for slots inside one word, normalized compare for
    straddling slots, out-of-domain keys turned into an unmatchable
    sentinel."""
    w = u32(tiles)
    kk = u32(keys)
    vmask = (1 << width) - 1
    in_domain = kk <= vmask
    acc = torch.zeros((kk.shape[0],) + tuple(w.shape[1:]), dtype=torch.int64, device=w.device)
    for r, (kw, s, straddles) in enumerate(unpack_schedule(width)):
        if straddles:
            x, want = unpack_value_plain(w, width, r), kk
        else:
            x = w[kw] & (vmask << s)
            want = torch.where(in_domain, kk << s, _U32)
        acc |= (x[None] == want[:, None, None]).to(torch.int64) << r
    valid = _valid_words(w.shape[1], n, block_offset, w.device)
    return _finish(acc, valid)


def shared_scan_tiles(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """tiles int32[width, B1, 128], keys int32[k] (uint32 bits, on the same
    device) -> (bits int32[k, B1, 128], counts int64[k]).

    ``block_offset`` is the global index of the tiles' first block, for a
    shard of a longer column of ``n`` values.

    The route's entry (:func:`_routed_scan`): each launch of
    MAX_LAUNCH_KEYS keys takes the kernel :func:`pick_route` names for its
    k; the keys are never read on the host.  The plain compare on CPU
    tensors."""
    return _routed_scan(tiles, keys, None, width, n, block_offset)


def _routed_scan(
    tiles: torch.Tensor, keys: torch.Tensor, host: np.ndarray | None, width: int, n: int,
    block_offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The route on ``keys`` (int32[k] on the tiles' device) -> (bits,
    counts): each launch of MAX_LAUNCH_KEYS keys on the kernel
    :func:`pick_route` names, each decision counted ``tier.<route>`` in
    span ``scan.pick_tier``.  ``host`` holds the same keys as a host uint32
    array where they came from the host (their "window" launches build
    window tables from it), else None.  On CUDA tensors each launch is
    counted under the wrapper of its kernel (``_ROUTE_KERNELS``); the
    plain compare on CPU tensors."""
    b1 = _check_tiles(tiles, width)
    _check_key_tensor(keys)
    k = int(keys.shape[0])
    with profiling.span("scan.pick_tier"):
        routes = [pick_route(width, min(k - g0, MAX_LAUNCH_KEYS), host is not None)
                  for g0 in range(0, k, MAX_LAUNCH_KEYS)]
    for route in routes:
        profiling.count("tier." + route)
    device = _cuda.kernel_device(tiles, keys)
    if device is None:
        return shared_scan_tiles_plain(tiles, keys, width, n, block_offset)
    bits, counts = _rows_out(k, b1, device)
    for g0, route in zip(range(0, k, MAX_LAUNCH_KEYS), routes):
        rows = min(k - g0, MAX_LAUNCH_KEYS)
        if route == "window":
            _window_launches(tiles, host[g0 : g0 + rows], g0, bits, counts, width, n,
                             block_offset, device)
        else:
            _launch_route(route, tiles, keys, g0, rows, bits, counts, width, n, block_offset,
                          device)
        profiling.count("launches." + _ROUTE_KERNELS[route][1])
    return bits, counts


def _rows_out(k: int, b1: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits int32[k, B1, 128], zeroed counts int64[k]) on ``device``."""
    return (torch.empty((k, b1, LANES), dtype=torch.int32, device=device),
            torch.zeros(k, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# The route: the kernel of one launch of arbitrary keys
# ---------------------------------------------------------------------------


# The widths and k of one launch that ``bench/redesign_sweep.py compare``
# timed (CUDA keys on ``i % 2^min(width, 9)`` columns of 256 MiB packed,
# less where the k rows would pass 16 GiB; NVIDIA H100 80GB HBM3, 700 W),
# and by width the k where the plane fold on the key tensor (the dynamic
# scan's lookup where ``_RUNTIME_LOOKUP_KS`` names the k) ran more than 5%
# faster than the compare kernel.  The compare kernel's work grows with k
# alone, the fold's with k x width, so the crossover moves from k = 1 at
# width 1 to 16 at width 31.
_COMPARE_SWEEP_WIDTHS = (1, 5, 9, 12, 16, 17, 20, 25, 31)
_COMPARE_SWEEP_KS = (1, 2, 3, 4, 5, 8, 16, 32, 64, 256, 1024)
_COMPARE_FOLD_KS = {
    1: (1, 2, 3, 4, 5, 8, 16, 32, 64, 256, 1024), 5: (2, 3, 4, 5, 8, 16, 32, 64, 256, 1024),
    **{w: (4, 5, 8, 16, 32, 64, 256, 1024) for w in (9, 12)},
    **{w: (8, 16, 32, 64, 256, 1024) for w in (16, 17, 20)},
    **{w: (16, 32, 64, 256, 1024) for w in (25, 31)},
}


def _around(grid: tuple, x: int) -> tuple[int, int] | None:
    """The measured points of ``grid`` at or around x (both x where x is
    one), or None outside the grid."""
    below = [m for m in grid if m <= x]
    above = [m for m in grid if m >= x]
    return (below[-1], above[0]) if below and above else None


def _won_around(sweep_widths: tuple, sweep_ks: tuple, wins: dict, width: int, k: int) -> bool:
    """Whether every measured point around (width, k) -- the swept widths
    and k at or on each side -- is a win in ``wins`` (width -> k)."""
    widths, ks = _around(sweep_widths, width), _around(sweep_ks, k)
    if widths is None or ks is None:
        return False
    return all(m in wins.get(w, ()) for w in widths for m in ks)


@profiling.watch_cache
@functools.lru_cache(maxsize=None)
def _compare_fold_wins(width: int, k: int) -> bool:
    """Whether one launch of k keys of a ``width``-bit column leaves the
    compare kernel for the plane fold's side of the route: where the
    ``compare`` sweep measured the fold more than 5% faster, or where
    every measured point around (width, k) did."""
    return _won_around(_COMPARE_SWEEP_WIDTHS, _COMPARE_SWEEP_KS, _COMPARE_FOLD_KS, width, k)


# The k of one launch that ``bench/redesign_sweep.py runtime`` timed (CUDA
# keys, i % 512 columns of 128 MiB packed, widths 9-31; NVIDIA H100 80GB
# HBM3, 700 W), and by width those where the dynamic scan's key lookup ran
# more than 5% faster than the plane fold; at no other width did it.
_RUNTIME_SWEEP_KS = (8, 64, 128, 192, 256, 384, 512, 768, 1024)
_RUNTIME_LOOKUP_KS = {
    10: (256, 384, 512, 768, 1024), 11: (192, 256, 384, 512, 768, 1024),
    12: (192, 256, 384, 512, 768, 1024), 20: (384, 768, 1024), 21: (1024,),
    22: (384, 768, 1024), 23: (384, 768, 1024), 24: (256, 384, 768, 1024),
    25: (192, 256, 384, 768, 1024), 26: (192, 256, 384, 512, 768, 1024),
    **{w: (128, 192, 256, 384, 512, 768, 1024) for w in range(27, 32)},
}


def _runtime_lookup_wins(width: int, k: int) -> bool:
    """Whether one launch of k keys of a ``width``-bit column takes the
    dynamic scan's key lookup in place of the plane fold: where the
    ``runtime`` sweep measured it more than 5% faster at k, or at both
    measured k around it.  The fold's work grows with k x width; past 12
    bits the lookup is a search."""
    wins = _RUNTIME_LOOKUP_KS.get(width, ())
    below = [m for m in _RUNTIME_SWEEP_KS if m <= k]
    above = [m for m in _RUNTIME_SWEEP_KS if m >= k]
    return bool(below and above) and below[-1] in wins and above[0] in wins


# The column of the lookup for host keys: the route's lookup points that
# ``bench/redesign_sweep.py windowed`` timed on host keys (1024 keys, a
# window each, on i % 512 columns of 64 MiB packed at widths 20 and 31;
# NVIDIA H100 80GB HBM3, 700 W), and by width the k where the window lookup
# on the keys' host-built tables (``sss_windowed_lookup``) ran more than 5%
# faster than the dynamic scan's lookup: 10.2% at width 20, 15.2% at 31.
_WINDOW_SWEEP_WIDTHS = (20, 31)
_WINDOW_SWEEP_KS = (1024,)
_WINDOW_LOOKUP_KS = {20: (1024,), 31: (1024,)}


def pick_route(width: int, k: int, host_keys: bool = False) -> str:
    """The kernel of one launch of k arbitrary keys (k <= MAX_LAUNCH_KEYS)
    of a ``width``-bit column, read from the H100 sweeps alone:
    ``"compare"`` (``sss_shared_scan``) unless :func:`_compare_fold_wins`,
    else ``"fold"`` (``sss_bitsliced_static_fold``) unless
    :func:`_runtime_lookup_wins`, else the lookup: ``"window"``
    (``sss_windowed_lookup``) for keys that came from the host
    (``host_keys``) where every measured point around (width, k) of
    ``_WINDOW_LOOKUP_KS`` is a win, else ``"lookup"``
    (``sss_shared_scan_dynamic``).  Every route sets bit r of row j iff
    value r equals key j."""
    if not _compare_fold_wins(width, k):
        return "compare"
    if not _runtime_lookup_wins(width, k):
        return "fold"
    if host_keys and _won_around(_WINDOW_SWEEP_WIDTHS, _WINDOW_SWEEP_KS, _WINDOW_LOOKUP_KS,
                                 width, k):
        return "window"
    return "lookup"


# route -> (C entry point, the wrapper whose ``launches.`` counter counts its
# launches in the route)
_ROUTE_KERNELS = {"compare": ("sss_shared_scan", "shared_scan_tiles"),
                  "fold": ("sss_bitsliced_static_fold", "shared_scan_bitsliced_tiles"),
                  "lookup": ("sss_shared_scan_dynamic", "shared_scan_dynamic_tiles"),
                  "window": ("sss_windowed_lookup", "windowed_scan_tiles")}


def _launch_route(
    route: str, tiles: torch.Tensor, keys: torch.Tensor, g0: int, rows: int, bits: torch.Tensor,
    counts: torch.Tensor, width: int, n: int, block_offset: int, device: torch.device,
) -> None:
    """The one launch site of the route's kernels on a key tensor:
    ``route``'s kernel (not ``"window"``, :func:`_window_launches`) on keys
    ``g0 .. g0 + rows - 1`` (in device memory) into the same rows
    of ``bits`` and ``counts``.  The fold and the compare kernel take at
    most MAX_LAUNCH_KEYS keys; the dynamic scan's entry splits more into
    launches of that many.  The caller counts them."""
    nblocks = tiles.shape[1] * LANES
    _cuda.launch(
        _ROUTE_KERNELS[route][0], device, tiles.data_ptr(), keys.data_ptr() + 4 * g0, rows,
        bits.data_ptr() + 4 * g0 * nblocks, counts.data_ptr() + 8 * g0, nblocks, width, n,
        block_offset,
    )


# ---------------------------------------------------------------------------
# Chunked and dynamic tiers: any k of arbitrary keys
# ---------------------------------------------------------------------------
#
# Both take the 32 values of a block unpacked once (a value is below
# 2^width, so keys >= 2^width, 0xFFFFFFFF included, match nothing).  The
# chunked tier looks each value up among a chunk's keys; the dynamic tier
# among all the keys of a launch (MAX_LAUNCH_KEYS).  The JAX package's
# benchmark runs them for k > 32; no dispatcher does.

# Keys per chunk of the chunked kernel, one CTA's rows in shared memory
# (kChunkKeys in csrc/shared_scan.cu).
CHUNK_KEYS = 64


def _lookup_rows_plain(
    vals: list[torch.Tensor], keys: torch.Tensor, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of ``keys`` (int64, uint32 values) by one search per value
    slot -> (rows int32 [k + 1, B1, 128], rep int64 [k]): ``rep[j]`` is the
    first index holding key j; each value is searched among the keys'
    sorted distinct values below 2^width and its bit scattered into the row
    of the first index holding the key it hit (row k: no key); key j's row
    is ``rows[rep[j]]``.  A word gets each bit once, so the int32 sums are
    its bits (bit 31 added as -2^31)."""
    k, device = keys.shape[0], vals[0].device
    local = torch.arange(k, device=device)
    rep = (keys[:, None] == keys[None, :]).to(torch.int8).argmax(dim=1)
    enters = (rep == local) & (keys < (1 << width))
    order = torch.argsort(keys[enters])
    sorted_keys, sorted_idx = keys[enters][order], local[enters][order]
    rows = torch.zeros((k + 1,) + tuple(vals[0].shape), dtype=torch.int32, device=device)
    if sorted_keys.numel():
        last = sorted_keys.numel() - 1
        for r, v in enumerate(vals):
            pos = torch.searchsorted(sorted_keys, v).clamp_(max=last)
            idx = torch.where(sorted_keys[pos] == v, sorted_idx[pos], k)
            bit = 1 << r if r < 31 else -(1 << 31)
            rows.scatter_add_(0, idx[None], torch.full(idx[None].shape, bit, dtype=torch.int32,
                                                       device=device))
    return rows, rep


def _rows_plain(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int, group: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits int32[k, B1, 128], counts int64[k]) of :func:`_lookup_rows_plain`
    over each run of ``group`` keys, its rows finished 32 at a time (which
    bounds the int64 words held at once)."""
    vals = _block_values_plain(tiles, width)
    kk = u32(keys)
    k, device = kk.shape[0], tiles.device
    valid = _valid_words(tiles.shape[1], n, block_offset, device)
    bits = torch.empty((k,) + tuple(tiles.shape[1:]), dtype=torch.int32, device=device)
    counts = torch.empty(k, dtype=torch.int64, device=device)
    for g0 in range(0, k, group):
        rows, rep = _lookup_rows_plain(vals, kk[g0 : g0 + group], width)
        for j0 in range(0, rep.shape[0], 32):
            sl = slice(g0 + j0, g0 + j0 + 32)
            bits[sl], counts[sl] = _finish(rows[rep[j0 : j0 + 32]], valid)
    return bits, counts


def shared_scan_chunked_tiles_plain(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`shared_scan_chunked_tiles`, same
    algorithm: for each chunk of CHUNK_KEYS keys, ``rep[j]`` (the first
    index of the chunk holding key j), every value searched among the
    chunk's sorted distinct keys below 2^width, one scatter of its bit into
    the row of the key it hit, and row j read as row ``rep[j]``."""
    return _rows_plain(tiles, keys, width, n, block_offset, CHUNK_KEYS)


def shared_scan_chunked_tiles(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`shared_scan_tiles` for any k (arbitrary keys,
    a CUDA tensor never read on the host): the keys in chunks of
    CHUNK_KEYS, each value looked up once among a chunk's keys.

    Kernel ``sss_shared_scan_chunked`` (``csrc/shared_scan.cu``) on CUDA
    tensors, one launch for any k; the plain version on CPU tensors."""
    b1 = _check_tiles(tiles, width)
    _check_key_tensor(keys)
    device = _cuda.kernel_device(tiles, keys)
    if device is None:
        return shared_scan_chunked_tiles_plain(tiles, keys, width, n, block_offset)
    k = int(keys.shape[0])
    bits = torch.empty((k, b1, LANES), dtype=torch.int32, device=device)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_shared_scan_chunked", device, tiles.data_ptr(), keys.data_ptr(), k, bits.data_ptr(),
        counts.data_ptr(), b1 * LANES, width, n, block_offset,
    )
    profiling.count("launches.shared_scan_chunked_tiles")
    return bits, counts


def shared_scan_dynamic_tiles_plain(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`shared_scan_dynamic_tiles`, the
    kernel's algorithm over the whole key tensor at once: ``rep[j]`` (the
    first index holding key j), every value searched among the sorted
    distinct keys below 2^width, one scatter of its bit into the row of the
    key it hit, and row j read as row ``rep[j]``."""
    return _rows_plain(tiles, keys, width, n, block_offset, max(int(keys.shape[0]), 1))


def shared_scan_dynamic_tiles(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`shared_scan_tiles` for any k (arbitrary keys,
    a CUDA tensor never read on the host): each value looked up once among
    the keys of a launch (the first index holding it), its bit set in that
    row, and the rows stored in groups of 64.

    Kernel ``sss_shared_scan_dynamic`` (``csrc/shared_scan.cu``) on CUDA
    tensors, the route's ``"lookup"`` (:func:`_launch_route`), in launches
    of MAX_LAUNCH_KEYS keys (each counted); the plain version on CPU
    tensors."""
    b1 = _check_tiles(tiles, width)
    _check_key_tensor(keys)
    device = _cuda.kernel_device(tiles, keys)
    if device is None:
        return shared_scan_dynamic_tiles_plain(tiles, keys, width, n, block_offset)
    k = int(keys.shape[0])
    bits, counts = _rows_out(k, b1, device)
    _launch_route("lookup", tiles, keys, 0, k, bits, counts, width, n, block_offset, device)
    profiling.count("launches.shared_scan_dynamic_tiles", -(-k // MAX_LAUNCH_KEYS))
    return bits, counts


# ---------------------------------------------------------------------------
# Shift canary
# ---------------------------------------------------------------------------

# Amounts >= 32 spanning [32, 2^32), including the band just below 2^32
# (the JAX package's canary list, scan.py _run_shift_canary).
CANARY_AMOUNTS = (32, 33, 63, 64, 255, 1024, 1 << 20, 1 << 31,
                  (1 << 32) - 32, (1 << 32) - 24, (1 << 32) - 8, (1 << 32) - 1,
                  40, 96, 4096, 1 << 16)

# Per-device cache of the canary's verdict (a fact of the card and compiler).
_SHIFT_SEMANTICS: dict[str, bool] = {}


def canary_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(base, amounts) int32[8, 128]: all-ones words and the canary's
    amounts, laid out as the JAX package lays them out."""
    amounts = np.broadcast_to(
        np.array(CANARY_AMOUNTS, np.uint32).reshape(2, 8, 1), (2, 8, LANES // 2)
    ).reshape(8, LANES)
    amounts = torch.from_numpy(amounts.view(np.int32).copy()).to(device)
    base = torch.full((8, LANES), -1, dtype=torch.int32, device=device)
    return base, amounts


def shift_canary_plain(base: torch.Tensor, amounts: torch.Tensor) -> torch.Tensor:
    """Plain version of the canary's shift: ``base << d`` with d >= 32
    giving 0 — the saturating semantics the gateless one-hot needs."""
    d = u32(amounts)
    return i32(torch.where(d < 32, u32(base) << torch.clamp(d, max=31), 0))


def run_shift_canary(
    base: torch.Tensor, amounts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``base << d`` -> (ptx, cxx), both int32 like ``base``.

    Kernel ``sss_shift_canary`` (``csrc/interval_scan.cu``) on CUDA
    tensors: the shift through PTX ``shl.b32`` and through C++ ``<<``.  On
    CPU tensors both are the plain version."""
    _cuda.check_int32("base", base, tuple(base.shape))
    _cuda.check_int32("amounts", amounts, tuple(base.shape))
    device = _cuda.kernel_device(base, amounts)
    if device is None:
        out = shift_canary_plain(base, amounts)
        return out, out
    out_ptx = torch.empty_like(base)
    out_cxx = torch.empty_like(base)
    _cuda.launch(
        "sss_shift_canary", device, base.data_ptr(), amounts.data_ptr(), out_ptx.data_ptr(),
        out_cxx.data_ptr(), base.numel(),
    )
    profiling.count("launches.run_shift_canary")
    return out_ptx, out_cxx


_CANARY_WORDS = np.array(CANARY_AMOUNTS, np.uint32)


def shift_verdict_plain(device="cpu") -> bool:
    """Plain version of :func:`shift_verdict`: the plain shift of all-ones
    by every canary amount, on ``device``, is 0."""
    return bool((shift_canary_plain(*canary_inputs(device)) == 0).all())


def shift_verdict(device) -> bool:
    """True iff the shift of all-ones by every canary amount gives 0.

    Kernel ``sss_shift_verdict`` (``csrc/interval_scan.cu``) on a CUDA
    device: one warp shifts through PTX ``shl.b32`` with the amounts passed
    by value and writes the ballot of nonzero results to pinned host
    memory, read after one sync (no host-to-device copy).  The plain
    version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return shift_verdict_plain()
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}: only CUDA devices launch kernels")
    word = np.zeros(1, np.uint32)
    _cuda.launch("sss_shift_verdict", device, _CANARY_WORDS.ctypes.data, _CANARY_WORDS.size,
                 word.ctypes.data)
    profiling.count("launches.shift_verdict")
    return int(word[0]) == 0


def shift_saturates(device) -> bool:
    """True iff the device's shift (PTX ``shl.b32`` on a CUDA device) yields
    0 for every canary amount >= 32 (:func:`shift_verdict`).  Measured once
    per device and cached; the interval and windowed kernels take the
    gateless one-hot only when this holds, else the gated one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    hit = _SHIFT_SEMANTICS.get(str(device))
    if hit is None:
        hit = _SHIFT_SEMANTICS[str(device)] = shift_verdict(device)
    return hit


# ---------------------------------------------------------------------------
# Interval tier: keys lo..lo+k-1
# ---------------------------------------------------------------------------


def _swapmove(a, b, m: int, s: int):
    """Swap bits of ``a`` at positions p+s with bits of ``b`` at p (p in m)."""
    t = ((a >> s) ^ b) & m
    return a ^ (t << s), b ^ t


def _transpose8x8_bytes(x: list) -> list:
    """Bit-slice 8x8 transpose over four byte channels: byte g, bit u of
    x[t] -> byte g, bit t of y[u] (12 SWAPMOVEs)."""
    x = list(x)
    for i in (0, 2, 4, 6):
        x[i], x[i + 1] = _swapmove(x[i], x[i + 1], 0x55555555, 1)
    for i in (0, 1, 4, 5):
        x[i], x[i + 2] = _swapmove(x[i], x[i + 2], 0x33333333, 2)
    for i in (0, 1, 2, 3):
        x[i], x[i + 4] = _swapmove(x[i], x[i + 4], 0x0F0F0F0F, 4)
    return x


def _mask_byte(m, byte: int, g: int):
    """Byte ``byte`` of mask m (int64 < 2^32), placed at byte position g."""
    sh = 8 * (byte - g)
    m = (m >> sh) if sh >= 0 else (m << -sh)
    return m & (0xFF << (8 * g))


def _onehot_plain(v: torch.Tensor, lo: int) -> torch.Tensor:
    """Match mask ``1 << (v - lo)`` (uint32 subtraction; 0 for amounts >= 32)."""
    d = (v - lo) & _U32
    return torch.where(d < 32, torch.ones_like(d) << torch.clamp(d, max=31), 0)


def _byte_rows(masks: list, byte: int) -> list:
    """Byte ``byte`` of the 32 values' masks -> the 8 bitvector words of its
    keys: X_t packs the byte of values {t, t+8, t+16, t+24}, then the 8x8
    transpose."""
    x = [
        _mask_byte(masks[t], byte, 0) | _mask_byte(masks[8 + t], byte, 1)
        | _mask_byte(masks[16 + t], byte, 2) | _mask_byte(masks[24 + t], byte, 3)
        for t in range(8)
    ]
    return _transpose8x8_bytes(x)


def interval_scan_tiles_plain(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`interval_scan_tiles`, same algorithm:
    one-hot ``1 << (v - lo)`` (uint32 subtraction, 0 for amounts >= 32),
    byte packing of slots {t, t+8, t+16, t+24}, 8x8 SWAPMOVE transpose, in
    32-key chunks."""
    vals = _block_values_plain(tiles, width)
    rows = []
    for j0 in range(0, k, 32):
        masks = [_onehot_plain(v, (lo + j0) & _U32) for v in vals]
        kc = min(32, k - j0)
        for byte in range((kc + 7) // 8):
            rows.extend(_byte_rows(masks, byte)[: min(8, kc - 8 * byte)])
    return _finish(torch.stack(rows), _valid_words(tiles.shape[1], n, block_offset, tiles.device))


def _check_interval(lo: int, k: int) -> None:
    if not (1 <= k <= MAX_INTERVAL_KEYS):
        raise ValueError(f"interval scan supports 1 <= k <= {MAX_INTERVAL_KEYS}, got {k}")
    if not (0 <= lo <= _U32):
        raise ValueError(f"lo must be a uint32 value, got {lo}")


def interval_scan_tiles(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared scan against the k consecutive keys lo..lo+k-1 (k <= 1024):
    the output contract of :func:`shared_scan_tiles` with
    keys = [lo, ..., lo+k-1].

    Kernel ``sss_interval_scan`` (``csrc/interval_scan.cu``) on CUDA
    tensors, with the gateless one-hot iff :func:`shift_saturates`; the
    plain version on CPU tensors."""
    lo, k = int(lo), int(k)
    _check_interval(lo, k)
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return interval_scan_tiles_plain(tiles, lo, k, width, n, block_offset)
    gateless = shift_saturates(device)
    bits = torch.empty((k, b1, LANES), dtype=torch.int32, device=device)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_interval_scan", device, tiles.data_ptr(), lo, k, bits.data_ptr(),
        counts.data_ptr(), b1 * LANES, width, n, block_offset, int(gateless),
    )
    profiling.count("launches.interval_scan_tiles")
    return bits, counts


# ---------------------------------------------------------------------------
# Bit-sliced rows: the plane fold
# ---------------------------------------------------------------------------
#
# The 32 values of a block are transposed into bit planes (plane p, bit r =
# bit p of value r) by a 5-stage SWAPMOVE butterfly pruned to the width's
# live planes; key j then matches where AND_p (plane_p ^ (bit_p(j) - 1)) is
# set.  The kernel reads the keys from device memory, so it takes keys
# given as a CUDA tensor and host keys copied to the card alike.


def _transpose_stages():
    """(shift, mask) per SWAPMOVE butterfly stage, in forward order."""
    stages = []
    j, m = 16, 0x0000FFFF
    while j:
        stages.append((j, m))
        j >>= 1
        if j:
            m = m ^ ((m << j) & 0xFFFFFFFF)
    return stages


def _transpose_bitplanes_plain(vs: list, nplanes: int = BLOCK_VALUES) -> list:
    """32 int64 tensors of 32-bit values -> the first ``nplanes`` bit-plane
    words (plane p, bit r = bit p of vs[r]): the 5-stage SWAPMOVE butterfly
    pruned to the live planes.  Liveness is propagated backward from the
    ``nplanes`` outputs; pairs with no live output are skipped, pairs with
    one live output take a one-sided merge."""
    stages = _transpose_stages()
    live = set(range(nplanes))
    live_after: list[set] = [set()] * len(stages)
    for si in range(len(stages) - 1, -1, -1):
        live_after[si] = live
        j = stages[si][0]
        live = {
            i for i in range(BLOCK_VALUES)
            if (i & ~j) in live or ((i & ~j) | j) in live
        }
    x = list(vs)
    for (j, m), out_live in zip(stages, live_after):
        for i in range(BLOCK_VALUES):
            if i & j:
                continue
            a_live, b_live = i in out_live, (i + j) in out_live
            if not (a_live or b_live):
                continue
            a, b = x[i], x[i + j]
            if a_live and b_live:
                x[i], x[i + j] = _swapmove(a, b, m, j)
            elif a_live:
                x[i] = (a & (~(m << j) & _U32)) | ((b & m) << j)
            else:
                x[i + j] = (b & (~m & _U32)) | ((a >> j) & m)
    return x[:nplanes]


def _bitplanes_plain(tiles: torch.Tensor, width: int) -> list[torch.Tensor]:
    return _transpose_bitplanes_plain(_block_values_plain(tiles, width), width)


def shared_scan_bitsliced_tiles_plain(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`shared_scan_bitsliced_tiles`, same
    algorithm: per key ``AND_p(plane_p ^ ((key >> p & 1) - 1))``, killed for
    keys >= 2^width (which would otherwise alias key mod 2^width)."""
    planes = _bitplanes_plain(tiles, width)
    kk = u32(keys)[:, None, None]
    acc = torch.where(kk < (1 << width), _U32, 0)
    for p, plane in enumerate(planes):
        acc = acc & (plane ^ ((((kk >> p) & 1) - 1) & _U32))
    valid = _valid_words(tiles.shape[1], n, block_offset, tiles.device)
    return _finish(acc, valid)


def shared_scan_bitsliced_tiles(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`shared_scan_tiles` for any k; the key values
    are never read on the host, so CUDA-tensor keys stay on the card.

    On CUDA tensors, one launch per MAX_LAUNCH_KEYS keys of the plane fold
    in tile order (``sss_bitsliced_static_fold``, ``csrc/bitsliced.cu``:
    each CTA stages the keys' plane masks in shared memory once), the
    route's ``"fold"`` (:func:`_fold`), each launch counted here; the plain
    version on CPU tensors."""
    _check_tiles(tiles, width)
    _check_key_tensor(keys)
    device = _cuda.kernel_device(tiles, keys)
    if device is None:
        return shared_scan_bitsliced_tiles_plain(tiles, keys, width, n, block_offset)
    out = _fold(tiles, keys, width, n, block_offset, device)
    profiling.count("launches.shared_scan_bitsliced_tiles", -(-keys.shape[0] // MAX_LAUNCH_KEYS))
    return out


def _fold(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int,
    device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plane fold on keys in device memory, one launch per
    MAX_LAUNCH_KEYS keys (:func:`_launch_route`) -> (bits, counts)."""
    k = int(keys.shape[0])
    bits, counts = _rows_out(k, tiles.shape[1], device)
    for g0 in range(0, k, MAX_LAUNCH_KEYS):
        _launch_route("fold", tiles, keys, g0, min(k - g0, MAX_LAUNCH_KEYS), bits, counts, width,
                      n, block_offset, device)
    return bits, counts


# ---------------------------------------------------------------------------
# Static bit-sliced row: host keys, and the AND-DAG of the JAX package
# ---------------------------------------------------------------------------
#
# On the card the host keys take the plane fold, copied to device memory
# once a key set.  The JAX package's kernel for them collapses the per-key
# fold into an AND-DAG over the planes and their negations:
#     match(key) = AND_p (bit_p(key) ? plane_p : ~plane_p)
# built as a balanced binary tree over the bit span with every subtree
# memoized, so keys sharing a sub-span pattern share its subtree.  Its
# builders and counting stand-ins stay for ``ops/member.py``,
# ``ops/aggregate.py`` and ``query.py``, which price the member and
# aggregate tiers with them.


def _combo(planes, lo, hi, pattern: int, memo: dict):
    """Vector with bit r set iff bits [lo, hi) of value r equal ``pattern``.

    ``planes`` are the bit-plane words (any operand with ``&`` and ``~``);
    subtrees are memoized in ``memo`` (shared across every key of one
    chunk) so common sub-patterns cost one AND total."""
    if hi - lo == 1:
        if pattern:
            return planes[lo]
        key = ("~", lo)
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = ~planes[lo]
        return hit
    key = (lo, hi, pattern)
    hit = memo.get(key)
    if hit is None:
        mid = (lo + hi + 1) // 2
        lob = mid - lo
        a = _combo(planes, lo, mid, pattern & ((1 << lob) - 1), memo)
        b = _combo(planes, mid, hi, pattern >> lob, memo)
        hit = memo[key] = a & b
    return hit


def _member_or_tree(planes, lo, hi, patterns, memo: dict):
    """Vector with bit r set iff bits [lo, hi) of value r are in
    ``patterns``: the OR across keys factored Shannon-style.  Patterns are
    grouped by their high-span projection; each group pays one high-span
    combo and one recursive low-span OR-tree.  Returns None when every
    pattern of the span is present (all-match; callers drop the AND)."""
    span = hi - lo
    pats = sorted(set(patterns))
    if len(pats) == (1 << span):
        return None
    if len(pats) == 1:
        return _combo(planes, lo, hi, pats[0], memo)
    key = ("or", lo, hi, tuple(pats))
    hit = memo.get(key)
    if hit is not None:
        return hit
    mid = (lo + hi + 1) // 2
    lob = mid - lo
    groups: dict[int, list[int]] = {}
    for p in pats:
        groups.setdefault(p >> lob, []).append(p & ((1 << lob) - 1))
    acc = None
    for hp in sorted(groups):
        lo_t = _member_or_tree(planes, lo, mid, groups[hp], memo)
        hi_t = _combo(planes, mid, hi, hp, memo)
        term = hi_t if lo_t is None else hi_t & lo_t
        acc = term if acc is None else acc | term
    memo[key] = acc
    return acc


class _CountVec:
    """Stand-in vector operand: every AND/OR/NOT/XOR/shift bumps a shared
    counter, so dispatch can price the exact DAG a concrete key set would
    compile to, and the bit-plane transpose (``ops/aggregate.py``)."""

    __slots__ = ("ctr",)

    def __init__(self, ctr):
        self.ctr = ctr

    def _op(self, other=None):
        self.ctr[0] += 1
        return self

    __and__ = _op
    __or__ = _op
    __xor__ = _op
    __lshift__ = _op
    __rshift__ = _op
    __invert__ = _op


def _build_dag(width: int, keys, member: bool, operand) -> list:
    """Build the match DAG of ``keys`` on ``width`` stand-in planes made by
    ``operand()``: the member OR-tree of the in-domain keys, or one
    ``_combo`` per in-domain key.  Returns the planes."""
    planes = [operand() for _ in range(width)]
    memo: dict = {}
    dom = 1 << width
    in_dom = [int(k) for k in keys if int(k) < dom]
    if member:
        if in_dom:
            _member_or_tree(planes, 0, width, in_dom, memo)
    else:
        for key in in_dom:
            _combo(planes, 0, width, key, memo)
    return planes


def _static_dag_ops(width: int, keys, member: bool = False) -> int:
    """Counted vector ops of the match DAG for one kernel body (one key
    chunk, or the whole set for the member OR-tree)."""
    ctr = [0]
    _build_dag(width, keys, member, lambda: _CountVec(ctr))
    return ctr[0]


class _LiveVec:
    """Stand-in DAG operand that records creation and last-use times, so a
    DAG's peak liveness is measured, not guessed."""

    __slots__ = ("env", "id")

    def __init__(self, env):
        self.env = env
        self.id = env.create()

    def _op(self, other=None):
        self.env.use(self.id)
        if isinstance(other, _LiveVec):
            self.env.use(other.id)
        return _LiveVec(self.env)

    __and__ = _op
    __or__ = _op
    __invert__ = _op


class _LiveEnv:
    __slots__ = ("t", "born", "last")

    def __init__(self):
        self.t = 0
        self.born: list[int] = []
        self.last: list[int] = []

    def create(self) -> int:
        self.t += 1
        self.born.append(self.t)
        self.last.append(self.t)
        return len(self.born) - 1

    def use(self, i: int) -> None:
        self.t += 1
        self.last[i] = self.t

    def peak(self) -> int:
        events = sorted([(b, 1) for b in self.born] + [(e + 1, -1) for e in self.last])
        cur = peak = 0
        for _, d in events:
            cur += d
            peak = max(peak, cur)
        return peak


def _static_dag_liveness(width: int, keys, member: bool = False) -> int:
    """Peak number of simultaneously live vectors of the match DAG, planes
    included (they are read throughout).  The member tier's cost rule
    prices out DAGs past ``member._ORTREE_MAX_LIVE`` with it."""
    env = _LiveEnv()
    planes = _build_dag(width, keys, member, lambda: _LiveVec(env))
    # planes stay live to the end (the kernel holds them across chunks)
    for p in planes:
        env.use(p.id)
    return env.peak()


def shared_scan_bitsliced_static_tiles_plain(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`shared_scan_bitsliced_static_tiles`,
    same algorithm: the plane fold over the host keys (placed on the tiles'
    device); keys >= 2^width give zero rows."""
    arr = _concrete_keys(keys, "shared_scan_bitsliced_static_tiles")
    return shared_scan_bitsliced_tiles_plain(tiles, _key_tensor(arr, tiles.device), width, n,
                                             block_offset)


@profiling.watch_cache
@functools.lru_cache(maxsize=64)
def _static_keys_on(keys: tuple, device: torch.device) -> torch.Tensor:
    """Host keys as int32 on ``device``, copied once per key set."""
    return _key_tensor(np.asarray(keys, dtype=np.uint32), device)


def _host_keys_on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """:func:`_static_keys_on` of host keys, in span ``scan.program``."""
    with profiling.span("scan.program"):
        return _static_keys_on(tuple(arr.tolist()), device)


def shared_scan_bitsliced_static_tiles(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`shared_scan_tiles` for host keys (a list,
    numpy array or CPU tensor), one row per caller-order key, duplicates
    included.  Raises on CUDA-tensor keys.

    On CUDA tiles the keys are copied to the card once a key set
    (:func:`_host_keys_on`) and take the plane fold of
    :func:`shared_scan_bitsliced_tiles` (:func:`_fold`), each launch
    counted here; the plain version on CPU tiles."""
    arr = _concrete_keys(keys, "shared_scan_bitsliced_static_tiles")
    _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return shared_scan_bitsliced_static_tiles_plain(tiles, arr, width, n, block_offset)
    out = _fold(tiles, _host_keys_on(arr, device), width, n, block_offset, device)
    profiling.count("launches.shared_scan_bitsliced_static_tiles",
                    -(-arr.shape[0] // MAX_LAUNCH_KEYS))
    return out


# ---------------------------------------------------------------------------
# Windowed tier: host keys through 32-aligned mask windows
# ---------------------------------------------------------------------------
#
# The JAX package's kernel (and the plain version here) is the interval
# kernel's one-shot mask generalized to any host key set: keys are grouped
# into 32-aligned windows of the value domain; one shift per (value, window)
# gives the 32-bit match mask of every key in the window, and one 8x8
# transpose per populated 8-key sub-window gives the bitvector words, stored
# straight to each key's caller-order row.  On the card a value costs one
# lookup in the host's window tables (:func:`_window_tables`) instead,
# whatever the windows.


def _window_plan(arr):
    """keys (concrete, caller order) -> (bases, plan).

    bases: sorted unique 32-aligned window bases.
    plan: per base, tuple of (byte, ((j, out_row), ...)) — sub-window byte
    index, bit j within it, and the caller-order output row."""
    arr = np.asarray(arr, dtype=np.uint32)
    by_base: dict[int, dict[int, list[tuple[int, int]]]] = {}
    for row, key in enumerate(arr.tolist()):
        base = key // 32 * 32
        off = key - base
        by_base.setdefault(base, {}).setdefault(off // 8, []).append((off % 8, row))
    bases = sorted(by_base)
    plan = tuple(
        tuple((byte, tuple(by_base[b][byte])) for byte in sorted(by_base[b]))
        for b in bases
    )
    return bases, plan


# Rows of one pass over a tile of the windowed and dynamic kernels
# (kDynGroup in csrc/shared_scan.cu), and the row index of no row.
_ROW_GROUP = 64
_NO_ROW = 0xFFFF


def _window_tables(keys: np.ndarray, width: int) -> tuple[np.ndarray, int, int, int]:
    """One launch's keys (at most MAX_LAUNCH_KEYS, caller order) -> (plan,
    nwin, nd, ndup), the tables ``sss_windowed_lookup`` stages: plan is
    int32 ``windows[nwin], masks[nwin], first[nwin], list[nd], rep[k],
    dstart[groups + 1], dlist[ndup]``.  The windows are the sorted distinct
    ``key >> 5`` of the nd distinct keys below 2^width; a window's mask has
    bit ``key & 31`` of each of its keys, and ``first`` the index in
    ``list`` of its smallest key; ``list`` gives each distinct key, in key
    order, the first row holding it.  ``rep[j]`` is the first row holding
    key j (_NO_ROW past the domain); ``dlist`` are the rows whose first
    occurrence lies in another group of _ROW_GROUP rows, by that group
    (``dlist[dstart[g]:dstart[g + 1]]``)."""
    keys = np.asarray(keys, dtype=np.uint32)
    k = keys.shape[0]
    inside = np.nonzero(keys.astype(np.int64) < (1 << width))[0]
    distinct, first_at = np.unique(keys[inside], return_index=True)
    first_rows = inside[first_at]
    rep = np.full(k, _NO_ROW, dtype=np.int64)
    rep[inside] = first_rows[np.searchsorted(distinct, keys[inside])]
    windows, first = np.unique(distinct >> 5, return_index=True)
    bit = np.left_shift(np.uint32(1), distinct & np.uint32(31))
    masks = np.bitwise_or.reduceat(bit, first) if distinct.size else bit
    rows = np.arange(k)
    later = np.nonzero((rep != _NO_ROW) & (rep // _ROW_GROUP != rows // _ROW_GROUP))[0]
    group = rep[later] // _ROW_GROUP
    dlist = later[np.argsort(group, kind="stable")]
    dstart = np.concatenate([[0], np.cumsum(np.bincount(group, minlength=-(-k // _ROW_GROUP)))])
    parts = [windows, masks, first, first_rows, rep, dstart, dlist]
    plan = np.concatenate([np.asarray(a, dtype=np.int64) for a in parts])
    return plan.astype(np.uint32).view(np.int32), len(windows), len(distinct), len(dlist)


@profiling.watch_cache
@functools.lru_cache(maxsize=64)
def _window_tables_on(keys: tuple, width: int, device: torch.device) -> list[tuple]:
    """(first row, rows, plan on ``device``, nwin, nd, ndup) per launch of
    MAX_LAUNCH_KEYS rows: :func:`_window_tables`, copied once per key set."""
    arr = np.asarray(keys, dtype=np.uint32)
    launches = []
    for r0 in range(0, arr.shape[0], MAX_LAUNCH_KEYS):
        part = arr[r0 : r0 + MAX_LAUNCH_KEYS]
        plan, nwin, nd, ndup = _window_tables(part, width)
        launches.append((r0, part.shape[0], torch.from_numpy(plan).to(device), nwin, nd, ndup))
    return launches


def windowed_scan_tiles_plain(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`windowed_scan_tiles`, same algorithm:
    per 32-aligned window the one-hot ``1 << (v - base)``, per populated
    8-key sub-window the byte packing and 8x8 transpose."""
    arr = _concrete_keys(keys, "windowed_scan_tiles")
    vals = _block_values_plain(tiles, width)
    rows: list = [None] * arr.shape[0]
    bases, plan = _window_plan(arr)
    for base, wplan in zip(bases, plan):
        masks = [_onehot_plain(v, base) for v in vals]
        for byte, jrows in wplan:
            y = _byte_rows(masks, byte)
            for j, row in jrows:
                rows[row] = y[j]
    valid = _valid_words(tiles.shape[1], n, block_offset, tiles.device)
    return _finish(torch.stack(rows), valid)


def _window_launches(
    tiles: torch.Tensor, arr: np.ndarray, r_base: int, bits: torch.Tensor, counts: torch.Tensor,
    width: int, n: int, block_offset: int, device: torch.device,
) -> int:
    """The one launch site of ``sss_windowed_lookup``: host keys ``arr``
    into rows ``r_base ..`` of ``bits`` and ``counts``, one launch per
    MAX_LAUNCH_KEYS keys, its tables built and copied to the card once per
    key set and width (span ``scan.program``) -> the launches."""
    with profiling.span("scan.program"):
        launches = _window_tables_on(tuple(arr.tolist()), width, device)
    for r0, rows, plan, nwin, nd, ndup in launches:
        _cuda.launch(
            "sss_windowed_lookup", device, tiles.data_ptr(), plan.data_ptr(), rows, nwin, nd,
            ndup, bits[r_base + r0].data_ptr(), counts[r_base + r0].data_ptr(),
            tiles.shape[1] * LANES, width, n, block_offset,
        )
    return len(launches)


def windowed_scan_tiles(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared scan for host keys (a list, numpy array or CPU tensor), any
    k, one row per caller-order key, duplicates included; same output
    contract as :func:`shared_scan_tiles`.  Raises on CUDA-tensor keys.

    On CUDA tiles, ``sss_windowed_lookup`` (``csrc/shared_scan.cu``: one
    lookup a value in the keys' window tables, the rows in passes of 64;
    :func:`_window_launches`), each launch counted here; the route's
    ``"window"``.  The plain version (the JAX package's one-hot windows)
    on CPU tiles."""
    arr = _concrete_keys(keys, "windowed_scan_tiles")
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return windowed_scan_tiles_plain(tiles, arr, width, n, block_offset)
    bits, counts = _rows_out(int(arr.shape[0]), b1, device)
    launched = _window_launches(tiles, arr, 0, bits, counts, width, n, block_offset, device)
    profiling.count("launches.windowed_scan_tiles", launched)
    return bits, counts


# ---------------------------------------------------------------------------
# Range-predicate shared scan: k predicates lo_j <= v < hi_j
# ---------------------------------------------------------------------------
#
# One unsigned compare per (value, range): (v - lo) mod 2^32 < (hi - lo) mod
# 2^32.  hi < lo is a wrapped, non-empty span, exactly as in the JAX
# package; hi = 2^32 (a run ending at 0xFFFFFFFF) wraps to 0 and gives the
# span 2^32 - lo, the half-open range [lo, 2^32).


def _bounds_tensor(values, device) -> torch.Tensor:
    """Range bounds in [0, 2^32] -> int32[k] (uint32 bits, 2^32 wrapped to
    0) on ``device``.  A CUDA tensor stays on its device and is not read."""
    if isinstance(values, torch.Tensor) and values.is_cuda:
        return i32(values.reshape(-1).to(torch.int64))
    arr = np.asarray(values.cpu() if isinstance(values, torch.Tensor) else values,
                     dtype=np.int64).reshape(-1)
    if arr.size and (arr.min() < 0 or arr.max() > 1 << 32):
        raise ValueError("range bounds must lie in [0, 2^32]")
    return torch.from_numpy((arr & _U32).astype(np.uint32).view(np.int32)).to(device)


def _check_rows(rows, b1: int) -> tuple[int, int]:
    start, count = (int(x) for x in rows)
    if not (0 <= start and 1 <= count and start + count <= b1):
        raise ValueError(f"rows {rows}: expected (start, count) within the {b1} block rows")
    return start, count


def range_scan_tiles_plain(
    tiles: torch.Tensor, lows: torch.Tensor, highs: torch.Tensor, width: int, n: int,
    block_offset: int = 0, rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`range_scan_tiles`, same algorithm:
    per value and range ``(v - lo) < (hi - lo)`` in uint32 arithmetic
    (int64 masked to 32 bits)."""
    if rows is not None:
        start, count = _check_rows(rows, tiles.shape[1])
        sub, counts = range_scan_tiles_plain(tiles[:, start : start + count], lows, highs, width,
                                             n, block_offset + start * LANES)
        bits = torch.zeros((sub.shape[0],) + tuple(tiles.shape[1:]), dtype=torch.int32,
                           device=tiles.device)
        bits[:, start : start + count] = sub
        return bits, counts
    lo = u32(lows)[:, None, None]
    span = (u32(highs)[:, None, None] - lo) & _U32
    acc = torch.zeros((lo.shape[0],) + tuple(tiles.shape[1:]), dtype=torch.int64,
                      device=tiles.device)
    for r, v in enumerate(_block_values_plain(tiles, width)):
        acc |= (((v[None] - lo) & _U32) < span).to(torch.int64) << r
    return _finish(acc, _valid_words(tiles.shape[1], n, block_offset, tiles.device))


def range_scan_tiles(
    tiles: torch.Tensor, lows: torch.Tensor, highs: torch.Tensor, width: int, n: int,
    block_offset: int = 0, rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k half-open range predicates [lo_j, hi_j) in one fused pass: lows
    and highs int32[k] (uint32 bits) on the tiles' device -> (bits
    int32[k, B1, 128], counts int64[k]), the contract of
    :func:`shared_scan_tiles`.

    ``rows=(start, count)`` scans block rows start..start+count-1 only (a
    zone map's pruned span): the JAX package's scan of the span sliced out
    with ``block_offset + start * 128``, its bits placed at their rows of
    otherwise zero full-length rows.  The kernel reads the span in place.

    Kernel ``sss_range_scan`` (``csrc/range_scan.cu``) on CUDA tensors;
    the plain version on CPU tensors."""
    b1 = _check_tiles(tiles, width)
    _check_key_tensor(lows)
    _cuda.check_int32("highs", highs, tuple(lows.shape))
    start, count = (0, b1) if rows is None else _check_rows(rows, b1)
    device = _cuda.kernel_device(tiles, lows, highs)
    if device is None:
        return range_scan_tiles_plain(tiles, lows, highs, width, n, block_offset, rows)
    k = int(lows.shape[0])
    alloc = torch.empty if rows is None else torch.zeros
    bits = alloc((k, b1, LANES), dtype=torch.int32, device=device)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    skip = start * LANES * 4  # bytes before the first scanned block of a row
    _cuda.launch(
        "sss_range_scan", device, tiles.data_ptr() + skip, lows.data_ptr(), highs.data_ptr(), k,
        bits.data_ptr() + skip, counts.data_ptr(), count * LANES, b1 * LANES, width, n,
        block_offset + start * LANES,
    )
    profiling.count("launches.range_scan_tiles")
    return bits, counts


def range_scan_device(dev: DeviceColumn, lows, highs) -> tuple[torch.Tensor, torch.Tensor]:
    """k range predicates on a DeviceColumn -> ((k, W) canonical
    bitvectors, (k,) int64 counts).  Bounds are host values in [0, 2^32]
    or a CUDA tensor (read on the card only).  Span
    ``scan.range_scan_device``."""
    with profiling.span("scan.range_scan_device"):
        device = dev.tiles.device
        bits, counts = range_scan_tiles(dev.tiles, _bounds_tensor(lows, device),
                                        _bounds_tensor(highs, device), dev.width, dev.n)
        return bits_to_canonical(bits, dev.n), counts


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def bits_to_canonical(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Bits layout [..., B1, 128] -> canonical words [..., W]."""
    lead = bits.shape[:-2]
    return bits.reshape(*lead, -1)[..., : bitvector_words(n)]


def popcount_bits(bits: torch.Tensor) -> torch.Tensor:
    """Hit counts from canonical bitvector words (axis -1), int64."""
    return popcount_words(bits).sum(dim=-1)


def _consecutive_lo(keys) -> int | None:
    """lo if keys are the consecutive run lo..lo+k-1 with 2 <= k <= 1024."""
    arr = _host_keys(keys)
    k = arr.shape[0]
    if not (2 <= k <= MAX_INTERVAL_KEYS):
        return None
    lo = int(arr[0])
    return lo if (arr == lo + np.arange(k, dtype=arr.dtype)).all() else None


def _runtime_keys(keys: torch.Tensor) -> torch.Tensor:
    """CUDA-tensor keys as contiguous int32[k] (uint32 bits) on their own
    device; nothing is copied to or read on the host."""
    keys = keys.reshape(-1)
    if keys.dtype != torch.int32:
        keys = i32(keys.to(torch.int64))
    return keys.contiguous()


def interval_or_keys(keys) -> tuple[int | None, np.ndarray | torch.Tensor]:
    """The shared scan's first decision -> (lo, keys): lo is the interval
    base where host keys are the consecutive run lo..lo+k-1 with 2 <= k <=
    1024 (counted ``tier.interval``), else None; keys come back as a host
    uint32 array, or as int32 on their card when given as a CUDA tensor
    (never read on the host, so never an interval).  The check runs in
    span ``scan.pick_tier``."""
    if _is_runtime_keys(keys):
        return None, _runtime_keys(keys)
    keys = _host_keys(keys)
    with profiling.span("scan.pick_tier"):
        lo = _consecutive_lo(keys)
    if lo is not None:
        profiling.count("tier.interval")
    return lo, keys


def shared_scan_device(dev: DeviceColumn, keys) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared scan on a DeviceColumn -> ((k, W) canonical bitvectors,
    (k,) int64 counts).

    Keys are host values (a list, numpy array or CPU tensor) or a CUDA
    tensor, the counterpart of the JAX package's traced keys, which is
    never copied to the host.  A host run of consecutive keys takes the
    interval kernel (:func:`interval_or_keys`); every other key set takes
    the route (:func:`_routed_scan`), each launch on the kernel
    :func:`pick_route` names, host keys copied to the card once a key set
    (span ``scan.program``).

    Span ``scan.shared_scan_device`` holds ``scan.pick_tier`` (the
    interval check and the route) and ``scan.program``; each decision
    counts ``tier.interval`` or ``tier.<route>``."""
    with profiling.span("scan.shared_scan_device"):
        lo, keys = interval_or_keys(keys)
        if lo is not None:
            bits, counts = interval_scan_tiles(dev.tiles, lo, keys.shape[0], dev.width, dev.n)
        else:
            host = keys if isinstance(keys, np.ndarray) else None
            if host is not None:
                keys = _host_keys_on(host, dev.tiles.device)
            bits, counts = _routed_scan(dev.tiles, keys, host, dev.width, dev.n, 0)
        return bits_to_canonical(bits, dev.n), counts


def scan_device(dev: DeviceColumn, predicate_key) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-predicate scan -> ((W,) canonical bitvector words, int64 count).
    A CUDA-tensor key stays on the card, as in :func:`shared_scan_device`."""
    if isinstance(predicate_key, torch.Tensor) and predicate_key.is_cuda:
        keys = predicate_key.reshape(1)
    else:
        keys = _host_keys(predicate_key).reshape(1)
    bits, counts = shared_scan_device(dev, keys)
    return bits[0], counts[0]


def interval_scan_device(dev: DeviceColumn, lo: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared scan for consecutive keys lo..lo+k-1 -> ((k, W) bitvectors,
    (k,) int64 counts)."""
    bits, counts = interval_scan_tiles(dev.tiles, lo, k, dev.width, dev.n)
    return bits_to_canonical(bits, dev.n), counts


# ---------------------------------------------------------------------------
# Histogram: counts of consecutive keys, no bitvector
# ---------------------------------------------------------------------------
#
# A full value histogram (counts of keys lo..lo+k-1, k up to 4096) cannot go
# through the bitvector kernels: k=512 bitvectors of a 512 MiB column would
# be 30 GB.  Three tiers count without them, as the JAX package's three:
# the runtime-lo kernel (histogram_tiles) and, for a host lo, the static
# AND-DAG interpreter in its counts-only form on the chunked programs (k <=
# 48 or k > 512), or the span tier (48 < k <= 512).  The JAX span kernel
# runs one memoized AND-DAG over all k keys because Mosaic has no scatter;
# here the span tier is the runtime-lo kernel's bins with lo passed by
# value and no wrap.

MAX_HISTOGRAM_KEYS = 4096


def _check_histogram_k(k: int) -> None:
    if not (1 <= k <= MAX_HISTOGRAM_KEYS):
        raise ValueError(f"histogram supports 1 <= k <= {MAX_HISTOGRAM_KEYS}, got {k}")


def _check_lo(lo: int) -> int:
    lo = int(lo)
    if not (0 <= lo <= _U32):
        raise ValueError(f"lo must be a uint32 value, got {lo}")
    return lo


def _lo_tensor(lo, device) -> torch.Tensor:
    """The histogram's low key as int32[1] (uint32 bits).  A tensor stays
    on its own device and is never read on the host; an int is placed on
    ``device``."""
    if isinstance(lo, torch.Tensor):
        if lo.numel() != 1:
            raise ValueError(f"lo: expected one value, got shape {tuple(lo.shape)}")
        return _runtime_keys(lo)
    arr = np.asarray([_check_lo(lo)], dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def _real_values_plain(
    tiles: torch.Tensor, width: int, n: int, block_offset: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 32 values of every block, int64 [32, B1, 128], and whether each
    is real (index < n)."""
    vals = torch.stack(_block_values_plain(tiles, width))
    valid = _valid_words(tiles.shape[1], n, block_offset, tiles.device)
    r = torch.arange(BLOCK_VALUES, dtype=torch.int64, device=tiles.device)[:, None, None]
    return vals, ((valid[None] >> r) & 1) == 1


def histogram_tiles_plain(
    tiles: torch.Tensor, lo, k: int, width: int, n: int, block_offset: int = 0
) -> torch.Tensor:
    """Plain torch version of :func:`histogram_tiles`: count j is the
    number of real values v with ``(v - lo) mod 2^32 == j``."""
    lo_t = u32(_lo_tensor(lo, tiles.device))
    vals, real = _real_values_plain(tiles, width, n, block_offset)
    d = (vals - lo_t) & _U32
    return torch.bincount(d[real & (d < k)], minlength=k)


def histogram_tiles(
    tiles: torch.Tensor, lo, k: int, width: int, n: int, block_offset: int = 0
) -> torch.Tensor:
    """Counts of the k consecutive keys lo..lo+k-1 (1 <= k <= 4096) without
    bitvectors -> int64[k] on the tiles' device, the JAX package's uint32
    counts.  ``lo`` is an int or a one-element tensor on the tiles' device,
    the port's counterpart of the JAX package's traced lo: a CUDA tensor is
    never read on the host.  ``lo + j`` wraps mod 2^32, as the reference's
    uint32 window does.

    Kernel ``sss_histogram`` (``csrc/histogram.cu``) on CUDA tensors; the
    plain version on CPU tensors."""
    k = int(k)
    _check_histogram_k(k)
    b1 = _check_tiles(tiles, width)
    lo_t = _lo_tensor(lo, tiles.device)
    device = _cuda.kernel_device(tiles, lo_t)
    if device is None:
        return histogram_tiles_plain(tiles, lo_t, k, width, n, block_offset)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch("sss_histogram", device, tiles.data_ptr(), lo_t.data_ptr(), k, counts.data_ptr(),
                 b1 * LANES, width, n, block_offset)
    profiling.count("launches.histogram_tiles")
    return counts


# Widths whose full-domain histogram takes one domain pass: past one
# 4096-value window, up to the statistics' cap.
DOMAIN_WIDTHS = range(13, 21)


def _histogram_domain_tiles_plain(
    tiles: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> torch.Tensor:
    """Plain torch version of :func:`_histogram_domain_tiles`: the real
    values counted by ``bincount``."""
    vals, real = _real_values_plain(tiles, width, n, block_offset)
    return torch.bincount(vals[real], minlength=1 << width)


def _histogram_domain_tiles(
    tiles: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> torch.Tensor:
    """Counts of every value of the domain of a column of width 13..20 in
    one pass -> int64[2^width] on the tiles' device: the counts of
    :func:`histogram_tiles` over the 4096-value windows lo = 0, 4096, ...,
    laid end to end.

    Kernel ``sss_histogram_domain`` (``csrc/histogram.cu``: each real
    value adds one to its int64 counter in device memory) on CUDA tiles;
    the plain version on CPU tiles."""
    if width not in DOMAIN_WIDTHS:
        raise ValueError(f"the domain histogram takes widths {DOMAIN_WIDTHS.start}.."
                         f"{DOMAIN_WIDTHS.stop - 1}, got {width}")
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return _histogram_domain_tiles_plain(tiles, width, n, block_offset)
    counts = torch.zeros(1 << width, dtype=torch.int64, device=device)
    _cuda.launch("sss_histogram_domain", device, tiles.data_ptr(), counts.data_ptr(), b1 * LANES,
                 width, n, block_offset)
    profiling.count("launches._histogram_domain_tiles")
    return counts


def _histogram_span_tiles_plain(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> torch.Tensor:
    """Plain torch version of :func:`_histogram_span_tiles` and
    :func:`_histogram_chunked_tiles`: the real values in [lo, lo + k),
    counted by ``bincount``."""
    vals, real = _real_values_plain(tiles, width, n, block_offset)
    d = vals - lo
    return torch.bincount(d[real & (d >= 0) & (d < k)], minlength=k)


_histogram_chunked_tiles_plain = _histogram_span_tiles_plain

def _histogram_fold_keys(width: int, lo: int, k: int) -> int:
    """How many keys :func:`_histogram_chunked_tiles` counts with the
    static fold's counts form: the keys of lo..lo+k-1 inside the domain
    (the rest count 0), where the committed sweep (``bench/redesign_sweep.py
    histdag``, uniform columns of 512 MiB packed at widths 1-6, 8, 9, 12;
    NVIDIA H100 80GB HBM3, 700 W) found the fold faster than the bins
    kernel by more than 10%; else 0, and the bins kernel counts all k.
    That is every window at width 1 (0.30-0.84 of the bins kernel's time:
    2^32 values on two bins), and windows short of the whole domain with
    at most 8 keys inside it up to width 4 (0.62-0.84) or 2 up to width 8
    (0.82-0.89).  A whole domain (lo 0, k >= 2^W) past width 1 takes the
    bins kernel's whole-domain path (0.19-0.60 of the fold's time), and so
    does every other window (the fold took 0.99-4.1x the bins kernel's
    time: 8 keys at widths 5 and 6, 2-64 at widths 9 and 12)."""
    dom = 1 << width
    inside = min(k, dom - lo) if lo < dom else 0
    if width == 1 or inside == 0:
        return inside
    whole = lo == 0 and k >= dom
    return inside if not whole and width <= 8 and inside <= (8 if width <= 4 else 2) else 0


def _histogram_chunked_tiles(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> torch.Tensor:
    """Counts of keys lo..lo+k-1 (host lo, any 1 <= k <= 4096) in one pass
    -> int64[k]: count j is the number of real values equal to lo + j, so
    a key past 2^width or past 2^32 - 1 counts 0 (no wrap).  The JAX
    package runs one ``_histogram_dag_tiles_impl`` per group of at most
    256 keys, each reading the whole column; here one launch counts all
    k.

    On CUDA tiles, by the committed sweep (:func:`_histogram_fold_keys`):
    at width 1 and for a few keys of a narrow column, kernel
    ``sss_histogram_fold`` (``csrc/bitsliced.cu``: the static fold's
    counts form on the keys inside the domain, each key's row popcounted
    and never stored); elsewhere kernel ``sss_histogram_span``
    (``csrc/histogram.cu``: the bins kernel with lo by value).  The plain
    version (the span tier's) on CPU tiles."""
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return _histogram_chunked_tiles_plain(tiles, lo, k, width, n, block_offset)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    fold = _histogram_fold_keys(width, lo, k)
    _cuda.launch("sss_histogram_fold" if fold else "sss_histogram_span", device, tiles.data_ptr(),
                 lo, fold or k, counts.data_ptr(), b1 * LANES, width, n, block_offset)
    profiling.count("launches._histogram_chunked_tiles")
    return counts


def _histogram_span_tiles(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> torch.Tensor:
    """Counts of keys lo..lo+k-1 (host lo) in one pass -> int64[k]: each
    real value in [lo, lo + k) adds one to its bin, so a key past 2^width
    or past 2^32 - 1 counts 0 (no wrap).

    Kernel ``sss_histogram_span`` (``csrc/histogram.cu``, the span form of
    the bins kernel) for CUDA tiles; the plain version on CPU tiles."""
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return _histogram_span_tiles_plain(tiles, lo, k, width, n, block_offset)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch("sss_histogram_span", device, tiles.data_ptr(), lo, k, counts.data_ptr(),
                 b1 * LANES, width, n, block_offset)
    profiling.count("launches._histogram_span_tiles")
    return counts


def histogram_dag_tiles(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0,
    single_pass: bool | None = None,
) -> torch.Tensor:
    """Histogram of keys lo..lo+k-1 for a host ``lo`` -> int64[k]; keys >=
    2^width count 0 (no wrap past 2^32).

    As the JAX package's ``histogram_dag_tiles``: 48 < k <= 512 takes the
    single-pass span tier (:func:`_histogram_span_tiles`, shared-memory
    bins), other k the tier of the JAX package's chunked AND-DAG programs
    (:func:`_histogram_chunked_tiles`, one pass here too); ``single_pass``
    forces either."""
    k = int(k)
    _check_histogram_k(k)
    lo = _check_lo(lo)
    if single_pass is None:
        single_pass = _histogram_single_pass(k)
    fn = _histogram_span_tiles if single_pass else _histogram_chunked_tiles
    return fn(tiles, lo, k, width, n, block_offset)


def _histogram_single_pass(k: int) -> bool:
    """Whether :func:`histogram_dag_tiles` takes the span tier for k keys."""
    return 48 < k <= 512


def histogram_dag_passes(k: int) -> int:
    """Passes over the packed column of :func:`histogram_dag_tiles`'s
    default dispatch for k keys, as the port makes them: one for every k
    (both tiers count all k keys in one launch; the JAX package's chunked
    tier makes one pass per static group)."""
    _check_histogram_k(k)
    return 1


def histogram_device(dev: DeviceColumn, lo=0, k: int | None = None) -> torch.Tensor:
    """Value histogram of a packed column -> int64 counts (k,), by default
    the full domain (k = 2^width, capped at 4096).  One pass over the
    packed words; no bitvector exists.

    Dispatch, as the JAX package's: a host ``lo`` (an int) goes to
    :func:`histogram_dag_tiles`; a ``lo`` given as a tensor is the port's
    traced lo and goes to :func:`histogram_tiles`, which never reads a
    CUDA tensor on the host."""
    if k is None:
        k = min(1 << dev.width, MAX_HISTOGRAM_KEYS)
    if isinstance(lo, torch.Tensor):
        return histogram_tiles(dev.tiles, lo, k, dev.width, dev.n)
    return histogram_dag_tiles(dev.tiles, lo, k, dev.width, dev.n)


# ---------------------------------------------------------------------------
# Linear export: the scan fused with the byte interleave
# ---------------------------------------------------------------------------
#
# The linear layout (ops/linear.py) stores block b's k rows as bytes
# [4bk, 4bk + 4k): byte q*k + j = byte q of row j.  The fused kernels build
# the rows as their bits-form siblings do and write these bytes instead,
# so the (k, W) bits never reach device memory; the padded output
# int32[B1, 128k] is the JAX package's (B1, 128k) tile form, and flat
# output its first nbytes*k/4 words.  They serve the k the JAX package's
# fused tiers serve (linear._mxu_supported, linear._mxu_large_supported);
# every other k takes a scan kernel and then the interleave kernel.


def _linear_rows_plain(bits: torch.Tensor) -> torch.Tensor:
    """Bits int32[k, B1, 128] -> their linear words int32[B1, 128k]."""
    from shared_simd_scan_tpu_torch.ops.linear import interleave_words_plain

    k, b1, _ = bits.shape
    return interleave_words_plain(bits.reshape(k, -1), b1 * LANES * k).reshape(b1, LANES * k)


def _linear_out(out: torch.Tensor, counts: torch.Tensor, n: int, flat: bool):
    """(padded words [B1, 128k], counts) -> flat words [nbytes*k/4] unless
    ``flat`` is False."""
    if not flat:
        return out, counts
    k = out.shape[1] // LANES
    return out.reshape(-1)[: (n + 7) // 8 * k // 4], counts


def _interval_linear_tiles_plain(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`_interval_linear_tiles_impl`: the
    interval scan's plain version, then the plain interleave."""
    bits, counts = interval_scan_tiles_plain(tiles, lo, k, width, n, block_offset)
    return _linear_rows_plain(bits), counts


def _interval_linear_tiles_impl(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys lo..lo+k-1 (k % 4 == 0, 4 <= k <= 128) -> (words int32[B1,
    128k], counts int64[k]).

    Kernel ``sss_interval_scan_linear`` (``csrc/interval_scan.cu``) on CUDA
    tiles, with the gateless one-hot iff :func:`shift_saturates`; the plain
    version on CPU tiles."""
    _check_interval(lo, k)
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return _interval_linear_tiles_plain(tiles, lo, k, width, n, block_offset)
    gateless = shift_saturates(device)
    out = torch.empty((b1, LANES * k), dtype=torch.int32, device=device)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_interval_scan_linear", device, tiles.data_ptr(), lo, k, out.data_ptr(),
        counts.data_ptr(), b1 * LANES, width, n, block_offset, int(gateless),
    )
    profiling.count("launches._interval_linear_tiles_impl")
    return out, counts


def interval_scan_linear_words_tiles(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0,
    flat: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused interval shared scan -> (int32[nbytes*k/4] linear words, int64
    counts [k]) for the consecutive keys lo..lo+k-1, k in 4/8/12/16.
    ``flat=False`` returns the padded tile form int32[B1, 128k], the
    shard-local shape a sharded export stitches along the block axis."""
    from shared_simd_scan_tpu_torch.ops.linear import _mxu_supported

    lo, k = int(lo), int(k)
    if not _mxu_supported(k):
        raise ValueError(f"fused linear interval scan needs k in 4/8/12/16, got {k}")
    out, counts = _interval_linear_tiles_impl(tiles, lo, k, width, n, block_offset)
    return _linear_out(out, counts, n, flat)


def interval_scan_linear_words_large(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused interval export for the k of the JAX package's two-level
    tier (linear._mxu_large_supported): the same kernel in one pass."""
    from shared_simd_scan_tpu_torch.ops.linear import _mxu_large_supported

    lo, k = int(lo), int(k)
    if not _mxu_large_supported(k):
        raise ValueError(f"fused two-level linear interval scan needs k % 8 == 0 in 24..128 or "
                         f"k % 4 == 0 in 20..64, got {k}")
    out, counts = _interval_linear_tiles_impl(tiles, lo, k, width, n)
    return _linear_out(out, counts, n, True)


def _linear_concrete_keys(keys, name: str) -> np.ndarray:
    """Host keys of a static linear tier; CUDA-tensor keys are refused with
    the JAX package's message for traced keys."""
    if isinstance(keys, torch.Tensor) and keys.is_cuda:
        raise TypeError(f"{name} requires concrete keys")
    return _host_keys(keys)


def _static_linear_tiles_plain(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`_static_linear_tiles_impl`, same
    algorithm: the plane fold over the host keys (placed on the tiles'
    device), then the plain interleave."""
    return _bitsliced_linear_tiles_plain(tiles, _key_tensor(keys, tiles.device), width, n,
                                         block_offset)


def _static_linear_tiles_impl(
    tiles: torch.Tensor, keys: np.ndarray, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host keys (k % 4 == 0, 4 <= k <= 128) -> (words int32[B1, 128k],
    counts int64[k]); keys >= 2^width give zero rows.

    Kernel ``sss_bitsliced_static_scan_linear`` (``csrc/bitsliced.cu``: the
    plane fold, the keys passed by value in the kernel's parameters and
    turned into plane masks in shared memory) for CUDA tiles; the plain
    version on CPU tiles."""
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return _static_linear_tiles_plain(tiles, keys, width, n, block_offset)
    host = np.ascontiguousarray(keys, dtype=np.uint32)
    k = int(host.shape[0])
    out = torch.empty((b1, LANES * k), dtype=torch.int32, device=device)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_bitsliced_static_scan_linear", device, tiles.data_ptr(), host.ctypes.data, k,
        out.data_ptr(), counts.data_ptr(), b1 * LANES, width, n, block_offset,
    )
    profiling.count("launches._static_linear_tiles_impl")
    return out, counts


def static_scan_linear_words_tiles(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0, flat: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused static shared scan -> (int32[nbytes*k/4] linear words, int64
    counts [k]) for any host key set (a list, numpy array or CPU tensor) of
    k in 4/8/12/16; ``flat`` as in :func:`interval_scan_linear_words_tiles`.
    The key-agnostic sibling of the interval form; raises on CUDA-tensor
    keys."""
    from shared_simd_scan_tpu_torch.ops.linear import _mxu_supported

    arr = _linear_concrete_keys(keys, "static_scan_linear_words_tiles")
    k = int(arr.shape[0])
    if not _mxu_supported(k):
        raise ValueError(f"fused linear static scan needs k in 4/8/12/16, got {k}")
    out, counts = _static_linear_tiles_impl(tiles, arr, width, n, block_offset)
    return _linear_out(out, counts, n, flat)


def static_scan_linear_words_large(
    tiles: torch.Tensor, keys, width: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused static export for the k of the JAX package's two-level
    tier, caller order kept (the byte contract is order-sensitive): the
    same kernel in one pass."""
    from shared_simd_scan_tpu_torch.ops.linear import _mxu_large_supported

    arr = _linear_concrete_keys(keys, "static_scan_linear_words_large")
    k = int(arr.shape[0])
    if not _mxu_large_supported(k):
        raise ValueError(f"fused two-level linear static scan needs k % 8 == 0 in 24..128 or "
                         f"k % 4 == 0 in 20..64, got {k}")
    out, counts = _static_linear_tiles_impl(tiles, arr, width, n)
    return _linear_out(out, counts, n, True)


def _bitsliced_linear_tiles_plain(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`_bitsliced_linear_tiles_impl`: the
    runtime tier's plain version, then the plain interleave."""
    bits, counts = shared_scan_bitsliced_tiles_plain(tiles, keys, width, n, block_offset)
    return _linear_rows_plain(bits), counts


def _bitsliced_linear_tiles_impl(
    tiles: torch.Tensor, keys: torch.Tensor, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys int32[k] on the tiles' device (k % 4 == 0, 4 <= k <= 128),
    never read on the host -> (words int32[B1, 128k], counts int64[k]).

    Kernel ``sss_bitsliced_scan_linear`` (``csrc/bitsliced.cu``: the
    static fold's body, each CTA staging the keys' plane masks in shared
    memory once) on CUDA tensors; the plain version on CPU tensors."""
    b1 = _check_tiles(tiles, width)
    _check_key_tensor(keys)
    device = _cuda.kernel_device(tiles, keys)
    if device is None:
        return _bitsliced_linear_tiles_plain(tiles, keys, width, n, block_offset)
    k = int(keys.shape[0])
    out = torch.empty((b1, LANES * k), dtype=torch.int32, device=device)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_bitsliced_scan_linear", device, tiles.data_ptr(), keys.data_ptr(), k,
        out.data_ptr(), counts.data_ptr(), b1 * LANES, width, n, block_offset,
    )
    profiling.count("launches._bitsliced_linear_tiles_impl")
    return out, counts


def _is_runtime_keys(keys) -> bool:
    """Keys given as a CUDA tensor: runtime keys, never read on the host."""
    return isinstance(keys, torch.Tensor) and keys.is_cuda


def _key_tensor(keys, device) -> torch.Tensor:
    """Keys as int32[k] (uint32 bits) on ``device``: a CUDA tensor stays
    where it is and is not read on the host; host keys are placed there."""
    if _is_runtime_keys(keys):
        return _runtime_keys(keys)
    return torch.from_numpy(_host_keys(keys).view(np.int32).copy()).to(device)


def bitsliced_scan_linear_words_tiles(
    tiles: torch.Tensor, keys, width: int, n: int, block_offset: int = 0, flat: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused runtime-key shared scan -> (int32[nbytes*k/4] linear words,
    int64 counts [k]) for k in 4/8/12/16; ``flat`` as in
    :func:`interval_scan_linear_words_tiles`.  Keys given as a CUDA tensor
    are never read on the host (the JAX package's traced keys)."""
    from shared_simd_scan_tpu_torch.ops.linear import _mxu_supported

    keys = _key_tensor(keys, tiles.device)
    k = int(keys.shape[0])
    if not _mxu_supported(k):
        raise ValueError(f"fused linear traced scan needs k in 4/8/12/16, got {k}")
    out, counts = _bitsliced_linear_tiles_impl(tiles, keys, width, n, block_offset)
    return _linear_out(out, counts, n, flat)


def bitsliced_scan_linear_words_large(
    tiles: torch.Tensor, keys, k: int, width: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused runtime-key export for the k of the JAX package's
    two-level tier: the same kernel in one pass."""
    from shared_simd_scan_tpu_torch.ops.linear import _mxu_large_supported

    keys = _key_tensor(keys, tiles.device)
    k = int(k)
    if not _mxu_large_supported(k) or keys.shape[0] != k:
        raise ValueError(f"fused two-level linear traced scan needs k % 8 == 0 in 24..128 or "
                         f"k % 4 == 0 in 20..64 keys, got k={k} and {keys.shape[0]} keys")
    out, counts = _bitsliced_linear_tiles_impl(tiles, keys, width, n)
    return _linear_out(out, counts, n, True)


def shared_scan_linear_words_device(dev: DeviceColumn, keys) -> torch.Tensor:
    """Linear shared scan -> int32[nbytes*k/4]: the linear bytes of
    :func:`shared_scan_linear_device` read as little-endian words, the
    form device-side consumers should use.  Requires k % 4 == 0.

    Dispatch, as the JAX package's: host keys with a fused k
    (linear._mxu_supported or linear._mxu_large_supported) take the fused
    interval kernel when :func:`_consecutive_lo` finds a run, else the fused
    static kernel; CUDA-tensor keys with a fused k take the fused runtime
    kernel; every other k takes :func:`shared_scan_device` and then
    linear.interleave_words."""
    from shared_simd_scan_tpu_torch.ops.linear import (
        _mxu_large_supported,
        _mxu_supported,
        interleave_words,
    )

    runtime = _is_runtime_keys(keys)
    keys = _runtime_keys(keys) if runtime else _host_keys(keys)
    k = int(keys.shape[0])
    if k % 4:
        raise ValueError("words view needs k % 4 == 0; use the uint8 form")
    single, large = _mxu_supported(k), _mxu_large_supported(k)
    if (single or large) and not runtime:
        lo = _consecutive_lo(keys)
        if lo is not None:
            fn = interval_scan_linear_words_tiles if single else interval_scan_linear_words_large
            out, _ = fn(dev.tiles, lo, k, dev.width, dev.n)
        else:
            fn = static_scan_linear_words_tiles if single else static_scan_linear_words_large
            out, _ = fn(dev.tiles, keys, dev.width, dev.n)
        return out
    if single:
        out, _ = bitsliced_scan_linear_words_tiles(dev.tiles, keys, dev.width, dev.n)
        return out
    if large:
        out, _ = bitsliced_scan_linear_words_large(dev.tiles, keys, k, dev.width, dev.n)
        return out
    bits, _ = shared_scan_device(dev, keys)
    return interleave_words(bits, (dev.n + 7) // 8 * k // 4)


def shared_scan_linear_device(dev: DeviceColumn, keys) -> torch.Tensor:
    """Linear (interleaved) shared scan -> uint8[nbytes*k], nbytes =
    ceil(n / 8): byte ``g*k + j`` is byte g of key j's bitvector, the
    reference's ``shared_scan_128_linear_standard`` byte order; any k.

    Dispatch, as the JAX package's: a fused k goes through
    :func:`shared_scan_linear_words_device` and views its words as bytes;
    every other k takes :func:`shared_scan_device` and then
    linear.interleave_device."""
    from shared_simd_scan_tpu_torch.ops.linear import (
        _mxu_large_supported,
        _mxu_supported,
        interleave_device,
    )

    keys = _runtime_keys(keys) if _is_runtime_keys(keys) else _host_keys(keys)
    k = int(keys.shape[0])
    nbytes = (dev.n + 7) // 8
    if _mxu_supported(k) or _mxu_large_supported(k):
        words = shared_scan_linear_words_device(dev, keys)
        return words.view(torch.uint8)[: nbytes * k]
    bits, _ = shared_scan_device(dev, keys)
    return interleave_device(bits, nbytes)
