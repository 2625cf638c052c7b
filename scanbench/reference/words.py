"""LSB-first bitvector words from a boolean mask, in plain torch: bit i of
the match set is bit i % 32 of word i // 32, and bits past the mask's end
are zero.  Words are int32 holding the uint32 bits."""
from __future__ import annotations

import torch

BLOCK_WORDS = 1 << 22  # words packed at a time (an int64 temporary of 1 GiB)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> int32[ceil(n / 32)] words on the mask's device."""
    n = mask.shape[0]
    nwords = (n + 31) // 32
    out = torch.empty(nwords, dtype=torch.int32, device=mask.device)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    for start in range(0, nwords, BLOCK_WORDS):
        stop = min(nwords, start + BLOCK_WORDS)
        block = mask[start * 32: stop * 32].to(torch.int64)
        pad = (stop - start) * 32 - block.shape[0]
        if pad:
            block = torch.cat([block, block.new_zeros(pad)])
        words = (block.view(-1, 32) << shifts).sum(dim=1)
        out[start:stop] = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return out


def blockwise(n: int, block: int = 1 << 26):
    """Slices covering 0..n in blocks, so temporaries stay small."""
    for start in range(0, n, block):
        yield slice(start, min(n, start + block))
