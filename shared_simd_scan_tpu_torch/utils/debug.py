"""Binary pretty-printers (reference src/util.cpp:15-49).

PyTorch counterpart of ``shared_simd_scan_tpu/utils/debug.py``: the same
strings for the same bytes.  ``dump_byte`` / ``dump_memory`` render packed
buffers bit by bit, LSB first within each byte, matching the storage order
of the packed column and match bitvectors, so a printed dump reads as the
value stream left to right.
"""
from __future__ import annotations

import numpy as np
import torch


def dump_byte(b: int) -> str:
    """One byte, LSB first (the stream order), e.g. 5 -> '10100000'."""
    return "".join("1" if (int(b) >> i) & 1 else "0" for i in range(8))


def _leading_bytes(buf, max_bytes: int) -> np.ndarray:
    """The first ``max_bytes`` bytes of a buffer as host uint8."""
    if isinstance(buf, (bytes, bytearray)):
        return np.frombuffer(bytes(buf), dtype=np.uint8)[:max_bytes]
    if isinstance(buf, torch.Tensor):
        # copy only the elements that hold the first max_bytes bytes
        flat = buf.detach().reshape(-1)
        flat = flat[: -(-max_bytes // flat.element_size())].cpu().contiguous()
        return flat.view(torch.uint8).numpy()[:max_bytes]
    return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)[:max_bytes]


def dump_memory(buf, max_bytes: int = 64) -> str:
    """Hex-offset lines of LSB-first bit groups for any buffer: a tensor on
    any device (read as its bytes), a numpy array, or bytes."""
    raw = _leading_bytes(buf, max_bytes)
    lines = []
    for off in range(0, len(raw), 8):
        row = " ".join(dump_byte(b) for b in raw[off : off + 8])
        lines.append(f"{off:#06x}  {row}")
    return "\n".join(lines)
