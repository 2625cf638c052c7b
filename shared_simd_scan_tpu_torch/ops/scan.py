"""Fused shared scans on the tile layout: the compare and interval tiers.

PyTorch counterpart of the main-path slice of
``shared_simd_scan_tpu/ops/scan.py``: the general compare kernel
(:func:`shared_scan_tiles`), the interval kernel for consecutive keys
(:func:`interval_scan_tiles`) with its shift canary
(:func:`shift_saturates`), and the dispatcher
(:func:`shared_scan_device` / :func:`scan_device`).

Output contract (the JAX package's): ``bits[k, B1, 128]`` holds one
LSB-first uint32 word per block and key, with bits of values at index
``>= n`` zero, so ``bits[j].reshape(-1)[:bitvector_words(n)]`` is key j's
canonical bitvector; counts are int64 and equal the JAX package's uint32
counts.

Each kernel wrapper launches its CUDA kernel (``csrc/shared_scan.cu``,
``csrc/interval_scan.cu``) on CUDA tensors and runs the plain torch
version beside it on CPU tensors.
"""
from __future__ import annotations

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

MAX_INTERVAL_KEYS = 1024
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

    Kernel ``sss_shared_scan`` (``csrc/shared_scan.cu``) on CUDA tensors;
    the plain version on CPU tensors."""
    b1 = _check_tiles(tiles, width)
    if keys.ndim != 1 or keys.shape[0] < 1:
        raise ValueError(f"keys: expected a non-empty 1-D tensor, got shape {tuple(keys.shape)}")
    _cuda.check_int32("keys", keys, (keys.shape[0],))
    device = _cuda.kernel_device(tiles, keys)
    if device is None:
        return shared_scan_tiles_plain(tiles, keys, width, n, block_offset)
    k = int(keys.shape[0])
    bits = torch.empty((k, b1, LANES), dtype=torch.int32, device=device)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    _cuda.launch(
        "sss_shared_scan", device, tiles.data_ptr(), keys.data_ptr(), k, bits.data_ptr(),
        counts.data_ptr(), b1 * LANES, width, n, block_offset,
    )
    shared_scan_tiles.launches += 1
    return bits, counts


shared_scan_tiles.launches = 0


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
    run_shift_canary.launches += 1
    return out_ptx, out_cxx


run_shift_canary.launches = 0


def shift_saturates(device) -> bool:
    """True iff the device's shift (PTX ``shl.b32`` on a CUDA device) yields
    0 for every canary amount >= 32.  Measured once per device and cached;
    the interval kernel takes the gateless one-hot only when this holds."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    hit = _SHIFT_SEMANTICS.get(str(device))
    if hit is None:
        out_ptx, _ = run_shift_canary(*canary_inputs(device))
        hit = _SHIFT_SEMANTICS[str(device)] = bool((out_ptx == 0).all())
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


def interval_scan_tiles_plain(
    tiles: torch.Tensor, lo: int, k: int, width: int, n: int, block_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`interval_scan_tiles`, same algorithm:
    one-hot ``1 << (v - lo)`` (uint32 subtraction, 0 for amounts >= 32),
    byte packing of slots {t, t+8, t+16, t+24}, 8x8 SWAPMOVE transpose, in
    32-key chunks."""
    w = u32(tiles)
    vals = [unpack_value_plain(w, width, r) for r in range(BLOCK_VALUES)]
    rows = []
    for j0 in range(0, k, 32):
        lo_c = (lo + j0) & _U32
        masks = []
        for v in vals:
            d = (v - lo_c) & _U32
            masks.append(torch.where(d < 32, torch.ones_like(d) << torch.clamp(d, max=31), 0))
        kc = min(32, k - j0)
        for byte in range((kc + 7) // 8):
            x = [
                _mask_byte(masks[t], byte, 0) | _mask_byte(masks[8 + t], byte, 1)
                | _mask_byte(masks[16 + t], byte, 2) | _mask_byte(masks[24 + t], byte, 3)
                for t in range(8)
            ]
            rows.extend(_transpose8x8_bytes(x)[: min(8, kc - 8 * byte)])
    return _finish(torch.stack(rows), _valid_words(w.shape[1], n, block_offset, w.device))


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
    interval_scan_tiles.launches += 1
    return bits, counts


interval_scan_tiles.launches = 0


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


def _host_keys(keys) -> np.ndarray:
    """Keys as a host uint32 array (a CUDA tensor is copied to the host)."""
    if isinstance(keys, torch.Tensor):
        keys = keys.detach().cpu().numpy()
    return np.asarray(keys, dtype=np.uint32).reshape(-1)


def _consecutive_lo(keys) -> int | None:
    """lo if keys are the consecutive run lo..lo+k-1 with 2 <= k <= 1024."""
    arr = _host_keys(keys)
    k = arr.shape[0]
    if not (2 <= k <= MAX_INTERVAL_KEYS):
        return None
    lo = int(arr[0])
    return lo if (arr == lo + np.arange(k, dtype=arr.dtype)).all() else None


def pick_tier(keys) -> tuple[str, int | None]:
    """(tier, lo) for a concrete key set: ("interval", lo) for a
    consecutive run of 2..1024 keys, else ("compare", None).

    This is the JAX package's ``pick_concrete_tier`` decision wherever that
    picks interval or compare (every k=1 key, every consecutive run, spread
    sets of k <= 3 at width 9).  Sets it sends to its windowed or static
    AND-DAG tiers go to compare here until those tiers are ported: the
    results are the same, only the speed differs."""
    lo = _consecutive_lo(keys)
    return ("interval", lo) if lo is not None else ("compare", None)


def shared_scan_device(dev: DeviceColumn, keys) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared scan on a DeviceColumn -> ((k, W) canonical bitvectors,
    (k,) int64 counts), dispatched by :func:`pick_tier`.

    ``keys`` are host values (a list, numpy array or tensor; a CUDA tensor
    is copied to the host for the dispatch decision)."""
    keys = _host_keys(keys)
    tier, lo = pick_tier(keys)
    if tier == "interval":
        bits, counts = interval_scan_tiles(dev.tiles, lo, keys.shape[0], dev.width, dev.n)
    else:
        keys_t = torch.from_numpy(keys.view(np.int32).copy()).to(dev.tiles.device)
        bits, counts = shared_scan_tiles(dev.tiles, keys_t, dev.width, dev.n)
    return bits_to_canonical(bits, dev.n), counts


def scan_device(dev: DeviceColumn, predicate_key) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-predicate scan -> ((W,) canonical bitvector words, int64 count)."""
    bits, counts = shared_scan_device(dev, _host_keys(predicate_key).reshape(1))
    return bits[0], counts[0]


def interval_scan_device(dev: DeviceColumn, lo: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared scan for consecutive keys lo..lo+k-1 -> ((k, W) bitvectors,
    (k,) int64 counts)."""
    bits, counts = interval_scan_tiles(dev.tiles, lo, k, dev.width, dev.n)
    return bits_to_canonical(bits, dev.n), counts
