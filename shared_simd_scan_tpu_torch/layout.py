"""Bit-packed column layout over torch tensors: buffer contracts, packing,
and device tiling.

PyTorch counterpart of ``shared_simd_scan_tpu/layout.py``, with the same
canonical format (a flat LSB-first bitstream in little-endian uint32 words)
and the same device tile layout ``tiles[width, B1, 128]``: block
``b = b1*128 + lane`` holds the ``width`` words of 32 consecutive values
along axis 0.  A CUDA thread that owns one block reads its words at stride
``B1*128``, so neighbouring threads read neighbouring words of each row.

uint32 data lives in ``torch.int32`` tensors.  The raw bits are those of the
JAX package's uint32 arrays, so arrays cross between the two packages
through numpy ``.view(np.int32)`` / ``.view(np.uint32)`` with no conversion.
torch has no usable uint32 arithmetic (no shifts) and int32 ``>>``
sign-extends, so the plain torch code here widens words to int64 holding
0..2^32-1 (:func:`u32`), computes, and narrows back (:func:`i32`).

Naming: :func:`to_device` keeps the JAX package's name for findability and
means "relayout into tiles"; the torch device is the explicit ``device``
keyword wherever a tensor is created.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Lane count of the tile layout (kept from the JAX package so tiles cross
# unchanged); the block axis is tiled by this.
LANES = 128
# B1 is padded to a multiple of this (small columns; see padded_blocks).
SUBLANES = 8
# Values per block. Fixed by the uint32 word size: 32 values * c bits = c words.
BLOCK_VALUES = 32

MIN_WIDTH = 1
MAX_WIDTH = 31

# Hit counts equal the JAX package's uint32 counts, so columns are capped
# at 2^32 - 1 values and a key can never match 2^32 rows.
MAX_VALUES = (1 << 32) - 1

_U32 = 0xFFFFFFFF


def _check_width(width: int) -> None:
    if not (MIN_WIDTH <= int(width) <= MAX_WIDTH):
        raise ValueError(f"width must be in [{MIN_WIDTH}, {MAX_WIDTH}], got {width}")


def _check_n(n: int) -> None:
    if not (0 <= int(n) <= MAX_VALUES):
        raise ValueError(
            f"column length {n} exceeds MAX_VALUES={MAX_VALUES}: hit counts "
            "must fit uint32; split the data into columns below the limit"
        )


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words (uint32 bits) -> int64 holding the unsigned value."""
    return words.to(torch.int64) & _U32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 holding its low 32 bits (the uint32 word's bits)."""
    x = x & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def packed_nbytes(width: int, n: int) -> int:
    """Exact payload bytes of a packed column (no padding): ceil(n*width/8)."""
    _check_width(width)
    return (n * width + 7) // 8


def packed_words(width: int, n: int) -> int:
    """Number of canonical uint32 words covering the payload."""
    return (n * width + 31) // 32


def num_blocks(n: int) -> int:
    """Blocks of 32 values covering n values (last block may be partial)."""
    return (n + BLOCK_VALUES - 1) // BLOCK_VALUES


def padded_blocks(n: int, lanes: int = LANES) -> int:
    """Blocks padded up to the tile shape, exactly as the JAX package pads
    them (B1 to a multiple of 8, 64 or 512 by size), so the tiles of the
    two packages are identical.  Padding blocks are zero and masked by the
    kernels' validity word."""
    b = max(num_blocks(n), 1)
    b1 = (b + lanes - 1) // lanes
    if b1 >= 4096:
        mult = 512
    elif b1 >= 256:
        mult = 64
    else:
        mult = SUBLANES
    b1 = ((b1 + mult - 1) // mult) * mult
    return b1 * lanes


def bitvector_words(n: int) -> int:
    """uint32 words in a match bitvector for n values."""
    return (n + 31) // 32


def unpack_schedule(width: int) -> list[tuple[int, int, bool]]:
    """Static per-value unpack schedule for one 32-value block.

    For value r in 0..31: (word index k, shift s, straddles); the value is
    ``(w[k] >> s) | (w[k+1] << (32-s))`` masked to ``width`` bits, and
    ``straddles`` is False when w[k+1] is not needed.  k+1 <= width-1
    always, so a block never reads its neighbour's words.
    """
    _check_width(width)
    sched = []
    for r in range(BLOCK_VALUES):
        p = r * width
        k, s = p // 32, p % 32
        straddles = s + width > 32
        assert (not straddles) or (k + 1 <= width - 1)
        sched.append((k, s, straddles))
    return sched


def pack_schedule(width: int) -> list[list[tuple[int, int, bool]]]:
    """Inverse schedule: for each word j in 0..width-1 of a block, the list
    of (value_index r, shift, is_right_shift) contributions.

    ``is_right_shift`` True means the contribution is ``value >> shift``
    (the high part of a straddling value), else ``value << shift``.
    """
    _check_width(width)
    contribs: list[list[tuple[int, int, bool]]] = [[] for _ in range(width)]
    for r, (k, s, straddles) in enumerate(unpack_schedule(width)):
        contribs[k].append((r, s, False))
        if straddles:
            contribs[k + 1].append((r, 32 - s, True))
    return contribs


# ---------------------------------------------------------------------------
# Packing (compression), plain torch
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None: entry points given host
    data run on the card unless the caller asks for the CPU.  Raises when
    there is no card; nothing falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to work on the CPU")
    return torch.device("cuda")


def _values_tensor(values, device=None) -> torch.Tensor:
    """1-D values (numpy, list or tensor) -> int64 tensor of uint32 values,
    on ``device`` (default: the tensor's own device, the card for host data)."""
    if isinstance(values, torch.Tensor):
        v = values.to(device=device if device is not None else values.device)
        v = v.to(torch.int64)
    else:
        v = torch.from_numpy(np.asarray(values).astype(np.int64)).to(resolve_device(device))
    if v.ndim != 1:
        raise ValueError(f"expected 1-D values, got shape {tuple(v.shape)}")
    return v & _U32


def _pack_blocks(vals: torch.Tensor, width: int) -> torch.Tensor:
    """vals (B, 32) int64 -> (B, width) int32 block words."""
    vals = vals & ((1 << width) - 1)
    words = []
    for contribs in pack_schedule(width):
        w = torch.zeros(vals.shape[0], dtype=torch.int64, device=vals.device)
        for r, shift, right in contribs:
            v = vals[:, r]
            w = w | ((v >> shift) if right else (v << shift))
        words.append(i32(w))
    return torch.stack(words, dim=1)


def _block_values(v: torch.Tensor, nblocks: int) -> torch.Tensor:
    """Flat int64 values zero-padded to ``nblocks`` blocks -> (nblocks, 32)."""
    pad = nblocks * BLOCK_VALUES - v.shape[0]
    if pad:
        v = torch.cat([v, torch.zeros(pad, dtype=v.dtype, device=v.device)])
    return v.reshape(nblocks, BLOCK_VALUES)


@dataclasses.dataclass(frozen=True)
class PackedColumn:
    """A bit-packed column in canonical flat-word form.

    ``words``: int32[num_blocks(n) * width] — the canonical LSB-first
    stream (uint32 bits), zero-padded to whole blocks.
    """

    width: int
    n: int
    words: torch.Tensor

    def __post_init__(self):
        _check_width(self.width)
        _check_n(self.n)

    @property
    def nbytes_payload(self) -> int:
        return packed_nbytes(self.width, self.n)

    def to_bytes(self) -> bytes:
        """Exact payload bytes — byte for byte the JAX package's buffer."""
        raw = self.words.cpu().numpy().view(np.uint32).astype("<u4").tobytes()
        return raw[: self.nbytes_payload]

    @classmethod
    def from_bytes(cls, data: bytes, width: int, n: int, *, device=None) -> "PackedColumn":
        """Payload bytes -> column, on ``device`` (default: the card)."""
        _check_width(width)
        buf = np.zeros(num_blocks(n) * width, dtype="<u4")
        payload = np.frombuffer(data[: packed_nbytes(width, n)], dtype=np.uint8)
        byte_view = buf.view(np.uint8)
        byte_view[: payload.shape[0]] = payload
        # zero any bits beyond n*width inside the last payload byte
        used_bits = n * width
        if used_bits % 8:
            byte_view[used_bits // 8] &= (1 << (used_bits % 8)) - 1
        words = torch.from_numpy(buf.view(np.int32)).to(resolve_device(device))
        return cls(width=width, n=n, words=words)


def pack(values, width: int, *, device=None) -> PackedColumn:
    """Compress 1-D unsigned values into a canonical PackedColumn (plain torch,
    32 lane-wise OR steps per word; no per-element loop).  The column lies
    on ``device``; by default on a tensor's own device, and on the card for
    host data (numpy or a list)."""
    _check_width(width)
    v = _values_tensor(values, device)
    n = int(v.shape[0])
    words = _pack_blocks(_block_values(v, num_blocks(n)), width)
    return PackedColumn(width=width, n=n, words=words.reshape(-1))


# ---------------------------------------------------------------------------
# Device tiling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceColumn:
    """A packed column in tile layout: int32[width, B1, 128] (uint32 bits).

    Block b = b1*128 + lane; axis 0 is the word-within-block axis.  ``n`` is
    the true value count; blocks past num_blocks(n) are zero padding.
    """

    width: int
    n: int
    tiles: torch.Tensor

    def __post_init__(self):
        _check_width(self.width)
        _check_n(self.n)

    @property
    def padded_values(self) -> int:
        return self.tiles.shape[1] * LANES * BLOCK_VALUES

    def to_numpy(self) -> np.ndarray:
        """The tiles as a uint32 numpy array, bit for bit — the JAX
        package's ``DeviceColumn.tiles`` for the same column."""
        return self.tiles.cpu().numpy().view(np.uint32)


def to_device(col: PackedColumn, *, device=None) -> DeviceColumn:
    """Relayout canonical -> tile layout (one transpose), placed on
    ``device`` (default: where the column's words are)."""
    words = col.words if device is None else col.words.to(device)
    b = num_blocks(col.n)
    bp = padded_blocks(col.n)
    blocks = words.reshape(b, col.width)
    if bp != b:
        pad = torch.zeros((bp - b, col.width), dtype=torch.int32, device=words.device)
        blocks = torch.cat([blocks, pad])
    tiles = blocks.T.reshape(col.width, bp // LANES, LANES).contiguous()
    return DeviceColumn(width=col.width, n=col.n, tiles=tiles)


def to_canonical(dev: DeviceColumn) -> PackedColumn:
    b = num_blocks(dev.n)
    words = dev.tiles.reshape(dev.width, -1).T[:b].reshape(-1)
    return PackedColumn(width=dev.width, n=dev.n, words=words)


def pack_device(values, width: int, *, device=None) -> DeviceColumn:
    """Compress straight into tile layout (plain torch, no canonical
    materialization), placed as :func:`pack` places its column."""
    _check_width(width)
    v = _values_tensor(values, device)
    n = int(v.shape[0])
    bp = padded_blocks(n)
    words = _pack_blocks(_block_values(v, bp), width)  # (bp, width)
    tiles = words.T.reshape(width, bp // LANES, LANES).contiguous()
    return DeviceColumn(width=width, n=n, tiles=tiles)


def from_jax_numpy(width: int, n: int, tiles_u32: np.ndarray, device) -> DeviceColumn:
    """A JAX-package column's tiles (as a uint32 numpy array, e.g.
    ``np.asarray(dev.tiles)``) -> this package's DeviceColumn, bit for bit."""
    tiles_u32 = np.ascontiguousarray(tiles_u32)
    if tiles_u32.dtype != np.uint32:
        raise TypeError(f"expected uint32 tiles, got {tiles_u32.dtype}")
    if tiles_u32.ndim != 3 or tiles_u32.shape[0] != width or tiles_u32.shape[2] != LANES:
        raise ValueError(f"expected tiles of shape ({width}, B1, {LANES}), got {tiles_u32.shape}")
    if tiles_u32.shape[1] * LANES * BLOCK_VALUES < n:
        raise ValueError(f"tiles of shape {tiles_u32.shape} cannot hold {n} values")
    tiles = torch.from_numpy(tiles_u32.view(np.int32).copy()).to(device)
    return DeviceColumn(width=width, n=n, tiles=tiles)
