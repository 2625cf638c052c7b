"""Unpack (decompress) and pack (compress) for the tile layout.

PyTorch counterpart of ``shared_simd_scan_tpu/ops/unpack.py``.  The value
layout is ``vals[32, B1, 128]``: ``vals[r, b1, lane]`` is value ``r`` of
block ``b1*128 + lane``; flat order is one transpose away
(:func:`values_to_flat`).

:func:`unpack_tiles` and :func:`pack_tiles` are kernel wrappers: on CUDA
tensors they launch the hand-written kernels in ``csrc/unpack.cu``; on CPU
tensors they run the plain torch versions beside them
(:func:`unpack_tiles_plain`, :func:`pack_tiles_plain`), which the tests
hold against the JAX package and ``chip_smoke.py`` holds the kernels
against on the card.
"""
from __future__ import annotations

import torch

from shared_simd_scan_tpu_torch.layout import (
    BLOCK_VALUES,
    LANES,
    DeviceColumn,
    _check_width,
    i32,
    pack_schedule,
    padded_blocks,
    u32,
    unpack_schedule,
)
from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.utils import profiling


def unpack_value_plain(w: torch.Tensor, width: int, r: int) -> torch.Tensor:
    """Value r (0..31) of every block; ``w`` is int64 words [width, ...]."""
    k, s, straddles = unpack_schedule(width)[r]
    v = w[k] >> s
    if straddles:
        v = v | (w[k + 1] << (32 - s))
    return v & ((1 << width) - 1)


def unpack_tiles_plain(tiles: torch.Tensor, width: int) -> torch.Tensor:
    """Plain torch version of :func:`unpack_tiles`."""
    w = u32(tiles)
    return torch.stack([unpack_value_plain(w, width, r).to(torch.int32)
                        for r in range(BLOCK_VALUES)])


def pack_tiles_plain(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Plain torch version of :func:`pack_tiles`."""
    mask = (1 << width) - 1
    words = []
    for contribs in pack_schedule(width):
        w = None
        for r, shift, right in contribs:
            v = u32(vals[r]) & mask
            part = (v >> shift) if right else (v << shift)
            w = part if w is None else (w | part)
        words.append(i32(w))
    return torch.stack(words)


def _check_tiles(tiles: torch.Tensor, width: int) -> int:
    _check_width(width)
    if tiles.ndim != 3:
        raise ValueError(f"tiles: expected 3 dimensions, got shape {tuple(tiles.shape)}")
    b1 = tiles.shape[1]
    _cuda.check_int32("tiles", tiles, (width, b1, LANES))
    return b1


def unpack_tiles(tiles: torch.Tensor, width: int) -> torch.Tensor:
    """tiles int32[width, B1, 128] -> values int32[32, B1, 128].

    Kernel ``sss_unpack`` (``csrc/unpack.cu``) on CUDA tensors; the plain
    version on CPU tensors."""
    b1 = _check_tiles(tiles, width)
    device = _cuda.kernel_device(tiles)
    if device is None:
        return unpack_tiles_plain(tiles, width)
    vals = torch.empty((BLOCK_VALUES, b1, LANES), dtype=torch.int32, device=device)
    _cuda.launch("sss_unpack", device, tiles.data_ptr(), vals.data_ptr(), b1 * LANES, width)
    profiling.count("launches.unpack_tiles")
    return vals


def pack_tiles(vals: torch.Tensor, width: int) -> torch.Tensor:
    """values int32[32, B1, 128] -> tiles int32[width, B1, 128]; values are
    masked to ``width`` bits first.

    Kernel ``sss_pack`` (``csrc/unpack.cu``) on CUDA tensors; the plain
    version on CPU tensors."""
    _check_width(width)
    if vals.ndim != 3:
        raise ValueError(f"vals: expected 3 dimensions, got shape {tuple(vals.shape)}")
    b1 = vals.shape[1]
    _cuda.check_int32("vals", vals, (BLOCK_VALUES, b1, LANES))
    device = _cuda.kernel_device(vals)
    if device is None:
        return pack_tiles_plain(vals, width)
    tiles = torch.empty((width, b1, LANES), dtype=torch.int32, device=device)
    _cuda.launch("sss_pack", device, vals.data_ptr(), tiles.data_ptr(), b1 * LANES, width)
    profiling.count("launches.pack_tiles")
    return tiles


def values_to_flat(vals: torch.Tensor, n: int) -> torch.Tensor:
    """Value layout [32, B1, 128] -> flat (n,) canonical order."""
    return vals.permute(1, 2, 0).reshape(-1)[:n]


def flat_to_values(flat: torch.Tensor, b1: int) -> torch.Tensor:
    """Flat values (zero-padded to b1*128*32) -> value layout, contiguous."""
    return flat.reshape(b1, LANES, BLOCK_VALUES).permute(2, 0, 1).contiguous()


def unpack_device(dev: DeviceColumn) -> torch.Tensor:
    """Decompress a DeviceColumn -> (n,) int32 values in canonical order."""
    return values_to_flat(unpack_tiles(dev.tiles, dev.width), dev.n)


def pack_device_kernel(values: torch.Tensor, width: int) -> DeviceColumn:
    """Compress flat (n,) values (an int32 or int64 tensor) into a
    DeviceColumn on the values' device through :func:`pack_tiles`."""
    if values.ndim != 1:
        raise ValueError(f"expected 1-D values, got shape {tuple(values.shape)}")
    n = int(values.shape[0])
    bp = padded_blocks(n)
    flat = torch.zeros(bp * BLOCK_VALUES, dtype=torch.int32, device=values.device)
    flat[:n] = values if values.dtype == torch.int32 else i32(values.to(torch.int64))
    tiles = pack_tiles(flat_to_values(flat, bp // LANES), width)
    return DeviceColumn(width=width, n=n, tiles=tiles)
