"""Column persistence: save/load packed columns and match bitvectors.

PyTorch counterpart of ``shared_simd_scan_tpu/io.py``, with the same file
format byte for byte, so a file written by either package loads in the
other.  The payload is the canonical LSB-first bitstream behind a small
self-describing header.

Format (little-endian):
    magic   4s   b"SSS1"
    kind    u8   1 = packed column, 2 = bitvector
    width   u8   bit width (column) / 0 (bitvector)
    _pad    u16  zero
    n       u64  value count (column) / bit count (bitvector)
    payload ceil(n*width/8) bytes (column) / ceil(n/8) bytes (bitvector)

A table is a directory: one ``<name>.sss`` file per column plus a
``MANIFEST.json`` of ``{name: {"width", "n"}}``.  Loaders put the data on
``device`` (default: the card).
"""
from __future__ import annotations

import json
import pathlib
import struct

import torch

from shared_simd_scan_tpu_torch import bitvector as bv
from shared_simd_scan_tpu_torch.layout import PackedColumn, packed_nbytes

MAGIC = b"SSS1"
_HEADER = struct.Struct("<4sBBHQ")
KIND_COLUMN = 1
KIND_BITVECTOR = 2


def save_column(col: PackedColumn, path) -> None:
    payload = col.to_bytes()
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, KIND_COLUMN, col.width, 0, col.n))
        f.write(payload)


def load_column(path, *, device=None) -> PackedColumn:
    data = pathlib.Path(path).read_bytes()
    magic, kind, width, _, n = _HEADER.unpack_from(data)
    if magic != MAGIC or kind != KIND_COLUMN:
        raise ValueError(f"{path}: not a packed-column file")
    need = packed_nbytes(width, n)
    payload = memoryview(data)[_HEADER.size : _HEADER.size + need]
    if len(payload) < need:
        raise ValueError(
            f"{path}: truncated column payload ({len(payload)} of {need} bytes)"
        )
    return PackedColumn.from_bytes(payload, width, n, device=device)


def save_table(columns: dict, dirpath) -> None:
    """Persist a dict of named PackedColumns as a directory: one
    ``<name>.sss`` file per column plus a ``MANIFEST.json`` recording
    (name, width, n).  Columns must share n (one table)."""
    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    ns = {c.n for c in columns.values()}
    if len(ns) > 1:
        raise ValueError(f"table columns must share n, got {sorted(ns)}")
    manifest = {}
    for name, col in columns.items():
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad column name: {name!r}")
        save_column(col, d / f"{name}.sss")
        manifest[name] = {"width": col.width, "n": col.n}
    (d / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))


def load_table(dirpath, *, device=None) -> dict:
    """Load a table directory -> dict of named PackedColumns (validated
    against the manifest)."""
    d = pathlib.Path(dirpath)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    out = {}
    for name, meta in manifest.items():
        if "/" in name or "\\" in name or name.startswith("."):
            # a hand-edited manifest must not escape the table directory
            raise ValueError(f"bad column name in manifest: {name!r}")
        col = load_column(d / f"{name}.sss", device=device)
        if col.width != meta["width"] or col.n != meta["n"]:
            raise ValueError(
                f"{name}: file disagrees with manifest "
                f"({col.width}/{col.n} vs {meta['width']}/{meta['n']})"
            )
        out[name] = col
    return out


def save_bitvector(bits: torch.Tensor, n: int, path) -> None:
    """bits: canonical bitvector words (int32 holding uint32 bits) for n values."""
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, KIND_BITVECTOR, 0, 0, n))
        f.write(bv.to_bytes(bits, n))


def load_bitvector(path, *, device=None) -> tuple[torch.Tensor, int]:
    data = pathlib.Path(path).read_bytes()
    magic, kind, _, _, n = _HEADER.unpack_from(data)
    if magic != MAGIC or kind != KIND_BITVECTOR:
        raise ValueError(f"{path}: not a bitvector file")
    need = (n + 7) // 8
    payload = memoryview(data)[_HEADER.size : _HEADER.size + need]
    if len(payload) < need:
        raise ValueError(
            f"{path}: truncated bitvector payload ({len(payload)} of {need} bytes)"
        )
    return bv.from_bytes(payload, n, device=device), n

