"""Benchmark data and verification for the shared scan (subset).

PyTorch counterpart of part of ``shared_simd_scan_tpu/bench/harness.py``:
the reference benchmark's corpus (:func:`synth_modk`), its value count for
a packed size (:func:`values_for`), and the verifier run before timing
(:func:`check_shared_scan`).
"""
from __future__ import annotations

import torch

from shared_simd_scan_tpu_torch import layout
from shared_simd_scan_tpu_torch.ops import oracle
from shared_simd_scan_tpu_torch.ops import scan as scan_ops


def synth_modk(n: int, k: int, width: int, *, device=None) -> torch.Tensor:
    """Shared-scan corpus ``i % k % min(512, 2^width)`` as int32[n], on
    ``device`` (default: the card)."""
    m = min(512, 1 << width)
    idx = torch.arange(n, dtype=torch.int64, device=layout.resolve_device(device))
    return (idx % k % m).to(torch.int32)


def values_for(data_size: int, width: int) -> int:
    """Value count whose packed payload is ~data_size bytes."""
    return max((data_size * 8) // width, layout.BLOCK_VALUES)


def check_shared_scan(dev: layout.DeviceColumn, keys, vals: torch.Tensor) -> bool:
    """Three-way verification of :func:`shared_scan_device` over the full
    column: counts against a direct compare of ``vals``; every bitvector
    word against the plain compare version (32 keys at a time); and the
    bitvectors of a 2M-value prefix against the gather oracle.  ``keys``
    go to the dispatcher as given (a CUDA tensor as runtime keys); the
    checks read them on the host."""
    bits, counts = scan_ops.shared_scan_device(dev, keys)
    keys = scan_ops._host_keys(keys)
    expect = torch.stack([(vals == int(key)).sum() for key in keys.view("int32")])
    ok = bool((counts.cpu() == expect.cpu()).all())
    for j0 in range(0, keys.shape[0], 32):
        if not ok:
            break
        kt = torch.from_numpy(keys[j0 : j0 + 32].view("int32").copy()).to(dev.tiles.device)
        pbits, pcounts = scan_ops.shared_scan_tiles_plain(dev.tiles, kt, dev.width, dev.n)
        ok = bool((bits[j0 : j0 + 32] == scan_ops.bits_to_canonical(pbits, dev.n)).all())
        ok = ok and bool((counts[j0 : j0 + 32] == pcounts).all())
    if ok:
        n_chk = min(dev.n, 2_000_000)
        w_chk = layout.bitvector_words(n_chk)
        col_chk = layout.pack(vals[:n_chk], dev.width)
        obits, _ = oracle.shared_scan_words(col_chk.words, keys, dev.width, n_chk)
        gbits = bits[:, :w_chk].clone()
        if n_chk % 32:
            gbits[:, -1] &= (1 << (n_chk % 32)) - 1
        ok = bool((gbits == obits).all())
    if not ok:
        print("    VERIFY FAILED: shared scan mismatch")
    return ok
