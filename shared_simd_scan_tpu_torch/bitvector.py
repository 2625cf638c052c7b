"""LSB-first match bitvectors (scan outputs) over torch int32 words.

PyTorch counterpart of ``shared_simd_scan_tpu/bitvector.py``, same
contract: bit ``i`` of the match set lives in word ``i // 32`` at bit
``i % 32`` (byte ``i // 8``, bit ``i % 8``), and bits at ``i >= n`` are
always zero.  Words are int32 tensors holding uint32 bits (see
``layout``); counts come back as int64.  torch has no popcount op, so
:func:`popcount_words` is a SWAR popcount.
"""
from __future__ import annotations

import numpy as np
import torch

from shared_simd_scan_tpu_torch.layout import i32, resolve_device, u32


def popcount_words(bits: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 word (int64, same shape): SWAR popcount."""
    x = u32(bits)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def get_bit(bits: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i of an LSB-first bitvector (bool)."""
    return ((u32(bits[i // 32]) >> (i % 32)) & 1).to(torch.bool)


def to_bool(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Expand bitvector words into a (n,) bool tensor."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    expanded = (u32(bits)[:, None] >> shifts[None, :]) & 1
    return expanded.reshape(-1)[:n].to(torch.bool)


def from_bool(mask: torch.Tensor) -> torch.Tensor:
    """Pack a (n,) bool tensor into LSB-first bitvector words."""
    m = mask.to(torch.int64)
    pad = (-m.shape[0]) % 32
    if pad:
        m = torch.cat([m, torch.zeros(pad, dtype=torch.int64, device=m.device)])
    shifts = torch.arange(32, dtype=torch.int64, device=m.device)
    return i32((m.reshape(-1, 32) << shifts[None, :]).sum(dim=1))


def logical_and(*bits: torch.Tensor) -> torch.Tensor:
    """AND of same-length bitvectors, word-wise."""
    out = bits[0]
    for b in bits[1:]:
        out = out & b
    return out


def logical_or(*bits: torch.Tensor) -> torch.Tensor:
    """OR of same-length bitvectors, word-wise."""
    out = bits[0]
    for b in bits[1:]:
        out = out | b
    return out


def logical_not(bits: torch.Tensor, n: int) -> torch.Tensor:
    """NOT of a bitvector over n values; bits at i >= n stay zero."""
    w = ~bits
    if n % 32:
        w[-1] &= (1 << (n % 32)) - 1  # < 2^31: a valid int32 mask
    return w


def logical_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a AND NOT b`` word-wise (a's tail bits are already zero)."""
    return a & ~b


def popcount(bits: torch.Tensor) -> torch.Tensor:
    """Total set bits across the bitvector words (int64 scalar)."""
    return popcount_words(bits).sum()


def rank(bits: torch.Tensor, i: int) -> torch.Tensor:
    """Number of set bits strictly below position i (int64 scalar)."""
    word = i // 32
    full = popcount_words(bits[:word]).sum()
    if word >= bits.shape[0]:
        return full
    part = u32(bits[word]) & ((1 << (i % 32)) - 1)
    return full + popcount_words(i32(part))


def match_indices(
    bits: torch.Tensor, n: int, size: int, fill_value: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Matching row indices from a match bitvector: (int32[size], count).

    The positions of set bits in ascending order, padded (or cut) to
    ``size`` with ``fill_value`` (default n)."""
    mask = to_bool(bits, n)
    idx = torch.nonzero(mask).reshape(-1)[:size].to(torch.int32)
    fill = n if fill_value is None else fill_value
    out = torch.full((size,), fill, dtype=torch.int32, device=bits.device)
    out[: idx.shape[0]] = idx
    return out, mask.to(torch.int64).sum()


def to_bytes(bits: torch.Tensor, n: int) -> bytes:
    """Exact ceil(n/8) payload bytes."""
    raw = bits.cpu().numpy().view(np.uint32).astype("<u4").tobytes()
    return raw[: (n + 7) // 8]


def from_bytes(data: bytes, n: int, *, device=None) -> torch.Tensor:
    """Payload bytes -> bitvector words, on ``device`` (default: the card)."""
    buf = np.zeros((n + 31) // 32, dtype="<u4")
    payload = np.frombuffer(data[: (n + 7) // 8], dtype=np.uint8)
    buf.view(np.uint8)[: payload.shape[0]] = payload
    if n % 32:
        buf[-1] &= np.uint32((1 << (n % 32)) - 1)
    return torch.from_numpy(buf.view(np.int32)).to(resolve_device(device))
