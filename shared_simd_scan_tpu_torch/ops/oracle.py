"""Plain torch oracles — the independent semantic check.

PyTorch counterpart of ``shared_simd_scan_tpu/ops/oracle.py``.  These work
on the canonical flat words (not the tile layout) by a per-value two-word
gather and funnel shift, so they share no code path with the tile kernels
or their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from shared_simd_scan_tpu_torch import bitvector
from shared_simd_scan_tpu_torch.layout import PackedColumn, i32, u32


def unpack_words(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Decompress canonical words -> (n,) int32 values.

    Per value i: stream bits [i*width, i*width+width) via a gather of word
    i*width//32 and, when straddling, its successor.
    """
    w = u32(words)
    start = torch.arange(n, dtype=torch.int64, device=words.device) * width
    k = start >> 5
    s = start & 31
    k1 = torch.clamp(k + 1, max=w.shape[0] - 1)
    # s == 0 never straddles (width <= 31): drop the successor's contribution
    hi = torch.where(s == 0, 0, w[k1] << (32 - s))
    return i32(((w[k] >> s) | hi) & ((1 << width) - 1))


def unpack(col: PackedColumn) -> torch.Tensor:
    return unpack_words(col.words, col.width, col.n)


def _keys_int64(keys, device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1)
    return torch.from_numpy(keys.astype(np.int64)).to(device)


def scan_words(
    words: torch.Tensor, predicate_key, width: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-predicate equality scan -> (bitvector words, int64 hit count)."""
    if isinstance(predicate_key, torch.Tensor):
        keys = predicate_key.reshape(1)
    else:
        keys = [predicate_key]
    bits, counts = shared_scan_words(words, keys, width, n)
    return bits[0], counts[0]


def scan(col: PackedColumn, predicate_key) -> tuple[torch.Tensor, torch.Tensor]:
    return scan_words(col.words, predicate_key, col.width, col.n)


def shared_scan_words(
    words: torch.Tensor, predicate_keys, width: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-predicate shared scan -> ((k, words) bitvectors, (k,) int64 counts)."""
    vals = u32(unpack_words(words, width, n))
    keys = _keys_int64(predicate_keys, words.device)
    bits = torch.stack([bitvector.from_bool(vals == key) for key in keys])
    return bits, bitvector.popcount_words(bits).sum(dim=1)


def shared_scan(col: PackedColumn, predicate_keys) -> tuple[torch.Tensor, torch.Tensor]:
    return shared_scan_words(col.words, predicate_keys, col.width, col.n)


def member_scan_words(
    words: torch.Tensor, predicate_keys, width: int, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """IN-list membership scan -> (one bitvector's words, int64 hit count).

    Ground truth for ops.member: bit i is set iff value i is in the key
    set; a duplicate key counts once (the bitvector is an OR), and a key
    outside the width's domain matches nothing."""
    vals = u32(unpack_words(words, width, n))
    keys = _keys_int64(predicate_keys, words.device)
    bits = bitvector.from_bool(torch.isin(vals, keys))
    return bits, bitvector.popcount_words(bits).sum()


def member_scan(col: PackedColumn, predicate_keys) -> tuple[torch.Tensor, torch.Tensor]:
    return member_scan_words(col.words, predicate_keys, col.width, col.n)


def aggregate_scan(
    pcol: PackedColumn, mcol: PackedColumn, predicate_keys
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ground truth for ops.aggregate: per-key exact SUM and COUNT of the
    measure column where the predicate column equals the key -> ((k,)
    int64 sums, (k,) int64 counts)."""
    p = u32(unpack(pcol))
    m = u32(unpack(mcol))
    keys = _keys_int64(predicate_keys, p.device)
    sums = torch.stack([torch.where(p == key, m, 0).sum() for key in keys])
    counts = torch.stack([(p == key).sum() for key in keys])
    return sums, counts


def shared_scan_linear(col: PackedColumn, predicate_keys) -> torch.Tensor:
    """Linear (interleaved) shared scan -> uint8[nbytes * k], nbytes =
    ceil(n / 8): byte ``g*k + j`` is byte g of key j's bitvector (the
    reference's ``shared_scan_128_linear_standard`` byte order)."""
    bits, _ = shared_scan(col, predicate_keys)  # (k, words) int32
    k = bits.shape[0]
    nbytes = (col.n + 7) // 8
    b = bits.contiguous().view(torch.uint8).reshape(k, -1)[:, :nbytes]  # little-endian bytes
    return b.t().reshape(-1)
