"""Data-parallel column sharding across devices and processes.

PyTorch counterpart of ``shared_simd_scan_tpu/parallel/dist.py``.  The
packed column is cut along the block axis into one shard a mesh slot, the
keys are replicated, every shard runs the single-device kernel wrapper on
its block range (``block_offset = s * local_b1 * 128`` for shard ``s``),
and the per-shard counts are reduced: summed over this process's shards,
then ``torch.distributed.all_reduce`` over the mesh's process group.
Bitvector outputs stay sharded, one tensor a local shard; :func:`fetch_global`
gathers them on demand.

Any block-aligned cut is self-contained (one block is 32 values in
``width`` whole words), so shards need no halo.  B1 is padded to a
multiple of ``mesh.size * 8`` exactly as the JAX package pads it, so each
shard's B1 equals the JAX shard's; padding blocks are zero and the kernels
mask every position at or past the global ``n``.

A :class:`Mesh` is this process's devices, one shard each (a device may
repeat: ``["cpu"] * 8`` is the counterpart of the JAX tests' forced
8-device CPU platform, ``["cuda:0"] * 4`` four shards on one card), and a
``torch.distributed`` process group, or None for one process.  Global
shard ``s = rank * len(devices) + i``.  Under :func:`initialize` the same
code runs in every process of the group; counts, sums, minima and maxima
come back equal in every process.

A process started by a launcher that sets ``LOCAL_RANK`` (``torchrun``,
one process a card) is bound to card ``LOCAL_RANK``: :func:`initialize`
makes it the current device before the group forms, and :func:`make_mesh`
gives that card alone, so the mesh spans every card of every process once
(``mesh.size`` is the world size, as the JAX mesh after
``jax.distributed.initialize`` spans each device of every process once).
Without ``LOCAL_RANK`` one process drives every local card.

Where the JAX package finalizes per-grid-step partials on the host
(``finalize_sums``, ``finalize_minmax``), the port's kernels return final
int64 values: counts and sums are summed, minima and maxima reduced with
MIN/MAX (an empty group's 2^wm / 0 survive both).  Sums come back as numpy
uint64 (n < 2^32 values below 2^31 cannot reach 2^63 in int64), counts,
minima and maxima as int64 tensors on the mesh's first device.

The shared scan takes the single-device route
(``ops/scan.py`` ``shared_scan_device``): a host run of 2..1024
consecutive keys takes the interval kernel, every other key set each
shard's route, whose launches run the kernel ``pick_route`` reads from the
H100 sweeps (the compare kernel, the plane fold, the dynamic scan's lookup
or, for host keys, the window lookup).  The JAX package's ``tier="xla"`` form
has no counterpart: the port has no plain-XLA tier.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as tdist

from shared_simd_scan_tpu_torch.layout import LANES, SUBLANES, DeviceColumn, resolve_device
from shared_simd_scan_tpu_torch.ops import aggregate as agg_ops
from shared_simd_scan_tpu_torch.ops import conj as conj_ops
from shared_simd_scan_tpu_torch.ops import member as member_ops
from shared_simd_scan_tpu_torch.ops import scan as scan_ops
from shared_simd_scan_tpu_torch.ops import unpack as unpack_ops


def _rank_card() -> torch.device | None:
    """The card of this process under a launcher that sets ``LOCAL_RANK``
    (torchrun: one process a card), else None.  Raises where there is no
    card or ``LOCAL_RANK`` names none of them; nothing falls back to card 0
    or to the CPU."""
    local_rank = os.environ.get("LOCAL_RANK")
    if local_rank is None:
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(f"LOCAL_RANK={local_rank} but no CUDA device: pass device='cpu' "
                           "(devices=['cpu']) for a CPU process")
    index, count = int(local_rank), torch.cuda.device_count()
    if not 0 <= index < count:
        raise ValueError(f"LOCAL_RANK={index} names no card: torch.cuda.device_count() is {count}")
    return torch.device("cuda", index)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device=None) -> None:
    """Join this process to the default process group (wraps
    ``torch.distributed.init_process_group``); afterwards :func:`make_mesh`
    spans every process of the group.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU.  With no
    ``device`` the card is ``LOCAL_RANK``'s where the launcher sets it (it
    raises where that card does not exist), else the current card.  A card
    with an index is made the current device before the group forms, so
    NCCL binds this process to it.  The no-argument form reads the standard
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    as torchrun sets them); pass ``init_method`` (``tcp://host:port`` or
    ``file://path``), ``world_size`` and ``rank`` to give them yourself."""
    device = resolve_device(_rank_card() if device is None else device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=-1 if world_size is None else world_size,
                             rank=-1 if rank is None else rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's devices, one shard each, and the process group that
    joins it to the other processes' (None: this process alone)."""

    devices: tuple
    group: object = None

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else tdist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else tdist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Shards across every process of the mesh."""
        return len(self.devices) * self.world_size

    def shard_index(self, i: int) -> int:
        """Global index of this process's shard ``i``."""
        return self.rank * len(self.devices) + i


def make_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over ``devices``, spanning every process of
    the default process group when :func:`initialize` has run.  With no
    ``devices``: ``LOCAL_RANK``'s card alone where the launcher sets it (one
    process a card), else every local CUDA device (one process a host);
    raises where there is no card."""
    if devices is None:
        card = _rank_card()
        if card is not None:
            devices = [card]
        elif not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices, e.g. ['cpu'] * 8, for a CPU mesh")
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devices), tdist.group.WORLD if tdist.is_initialized() else None)


@dataclasses.dataclass(frozen=True)
class ShardedColumn:
    """A packed column cut along the block axis over a mesh: ``shards[i]``
    is this process's shard i, a contiguous int32[width, b1 / mesh.size,
    128] tensor on ``mesh.devices[i]``; ``n`` and ``b1`` are the global
    value count and padded B1."""

    width: int
    n: int
    b1: int
    shards: tuple
    mesh: Mesh

    @property
    def local_b1(self) -> int:
        return self.b1 // self.mesh.size

    def block_offset(self, i: int) -> int:
        """Global index of the first block of this process's shard i."""
        return self.mesh.shard_index(i) * self.local_b1 * LANES


def _pad_b1(b1: int, multiple: int) -> int:
    return -(-b1 // multiple) * multiple


def shard_column(dev: DeviceColumn, mesh: Mesh) -> ShardedColumn:
    """Cut a DeviceColumn's tiles along the block axis, one shard a mesh
    slot, B1 zero-padded to a multiple of (mesh size x 8).

    Every process of a multi-process mesh is assumed to hold the same
    column (a replicated build, as the demo and the tests have it) and
    materializes only its own shards, each a contiguous copy on its
    device."""
    width, b1 = dev.tiles.shape[0], dev.tiles.shape[1]
    total = _pad_b1(b1, mesh.size * SUBLANES)
    lb = total // mesh.size
    shards = []
    for i, device in enumerate(mesh.devices):
        start = mesh.shard_index(i) * lb
        part = dev.tiles[:, start : start + lb]
        shard = torch.empty((width, lb, LANES), dtype=torch.int32, device=device)
        shard[:, : part.shape[1]].copy_(part)
        shard[:, part.shape[1] :].zero_()
        shards.append(shard)
    return ShardedColumn(width=dev.width, n=dev.n, b1=total, shards=tuple(shards), mesh=mesh)


def _check_column(dev, mesh: Mesh) -> None:
    if not isinstance(dev, ShardedColumn):
        raise TypeError(f"expected a ShardedColumn (dist.shard_column), got {type(dev).__name__}")
    if dev.mesh != mesh:
        raise ValueError("the column is sharded over another mesh")


def _check_pair(pdev, mdev, mesh: Mesh) -> None:
    _check_column(pdev, mesh)
    _check_column(mdev, mesh)
    agg_ops._check_same_n(pdev, mdev)


_OPS = {"sum": (torch.add, tdist.ReduceOp.SUM), "min": (torch.minimum, tdist.ReduceOp.MIN),
        "max": (torch.maximum, tdist.ReduceOp.MAX)}


def _reduce(parts, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """Per-shard results -> one result on the mesh's first device: combined
    over this process's shards, then all-reduced over the group."""
    combine, reduce_op = _OPS[op]
    first = mesh.devices[0]
    out = parts[0].to(first)
    for p in parts[1:]:
        out = combine(out, p.to(first))
    if mesh.group is not None:
        tdist.all_reduce(out, op=reduce_op, group=mesh.group)
    return out


def fetch_global(x, mesh: Mesh) -> torch.Tensor:
    """The global tensor of per-shard outputs ``x`` (this process's shards,
    in order; equal shapes): the shards concatenated along the block axis
    (dim -2), gathered from every process of the group in rank order, on
    the mesh's first device.  Bit for bit the JAX package's global array.
    Collective on a multi-process mesh: every process must call it."""
    first = mesh.devices[0]
    local = torch.cat([p.to(first) for p in x], dim=-2)
    if mesh.group is None:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    tdist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts, dim=-2)


def _run(dev: ShardedColumn, fn) -> list:
    """``fn(shard, block_offset)`` for each of this process's shards."""
    return [fn(t, dev.block_offset(i)) for i, t in enumerate(dev.shards)]


def _split(outs, mesh: Mesh):
    """[(rows, count), ...] per shard -> (rows per shard, summed counts)."""
    return [r for r, _ in outs], _reduce([c for _, c in outs], mesh)


def _is_runtime_keys(keys) -> bool:
    return isinstance(keys, torch.Tensor) and keys.is_cuda


class _KeysOn:
    """Keys as int32[k] on each shard's device, placed once a device; CUDA
    keys are moved between cards only, never read on the host."""

    def __init__(self, keys, convert=scan_ops._key_tensor):
        self.keys, self.convert, self.on = keys, convert, {}

    def __call__(self, device) -> torch.Tensor:
        if device not in self.on:
            self.on[device] = self.convert(self.keys, device).to(device)
        return self.on[device]


def sharded_shared_scan(dev: ShardedColumn, keys, mesh: Mesh):
    """k-predicate shared scan over a sharded column -> (bits, a list of
    int32[k, B1/S, 128] per shard; counts int64[k], all-reduced).

    The single-device route: ``scan.interval_or_keys`` sends a host run of
    consecutive keys to the interval kernel, every other key set (host
    keys, or a CUDA tensor never read on the host) to each shard's
    ``scan._routed_scan``."""
    _check_column(dev, mesh)
    w, n = dev.width, dev.n
    lo, keys = scan_ops.interval_or_keys(keys)
    k = int(keys.shape[0])
    if lo is not None:
        def fn(t, off):
            return scan_ops.interval_scan_tiles(t, lo, k, w, n, off)
    else:
        host = keys if isinstance(keys, np.ndarray) else None
        on = _KeysOn(keys)

        def fn(t, off):
            return scan_ops._routed_scan(t, on(t.device), host, w, n, off)
    return _split(_run(dev, fn), mesh)


def sharded_scan(dev: ShardedColumn, predicate_key, mesh: Mesh):
    """Single-predicate sharded scan -> (bits, a list of int32[B1/S, 128]
    per shard; int64 count).  A CUDA-tensor key stays on the card."""
    if _is_runtime_keys(predicate_key):
        keys = predicate_key.reshape(1)
    else:
        keys = scan_ops._host_keys(predicate_key).reshape(1)
    bits, counts = sharded_shared_scan(dev, keys, mesh)
    return [b[0] for b in bits], counts[0]


def sharded_unpack(dev: ShardedColumn, mesh: Mesh) -> list:
    """Decompress a sharded column -> values, a list of int32[32, B1/S,
    128] per shard (no collective: each shard on its own)."""
    _check_column(dev, mesh)
    return [unpack_ops.unpack_tiles(t, dev.width) for t in dev.shards]


def sharded_interval_scan(dev: ShardedColumn, lo: int, k: int, mesh: Mesh):
    """Sharded shared scan for the consecutive keys lo..lo+k-1 (the
    interval kernel) -> (bits per shard, counts int64[k], all-reduced)."""
    _check_column(dev, mesh)
    lo, k = int(lo), int(k)
    return _split(_run(dev, lambda t, off: scan_ops.interval_scan_tiles(
        t, lo, k, dev.width, dev.n, off)), mesh)


def sharded_linear_scan(dev: ShardedColumn, lo: int, k: int, mesh: Mesh):
    """Sharded fused linear export of the interval keys lo..lo+k-1 (k in
    4/8/12/16) -> (words, a list of int32[B1/S, 128k] per shard: the
    block of the JAX package's ``P(DATA_AXIS, None)`` output each shard
    holds, a contiguous span of the global linear stream; counts int64[k],
    all-reduced).  ``fetch_global(words, mesh).reshape(-1)[:nwords]``, with
    nwords = ceil(n / 8) * k / 4, is the single-device linear stream."""
    _check_column(dev, mesh)
    lo, k = int(lo), int(k)
    return _split(_run(dev, lambda t, off: scan_ops.interval_scan_linear_words_tiles(
        t, lo, k, dev.width, dev.n, off, flat=False)), mesh)


def sharded_static_linear_scan(dev: ShardedColumn, keys, mesh: Mesh):
    """Sharded fused linear export for any host key set of k in
    4/8/12/16: the output contract of :func:`sharded_linear_scan`."""
    _check_column(dev, mesh)
    arr = scan_ops._linear_concrete_keys(keys, "sharded_static_linear_scan")
    return _split(_run(dev, lambda t, off: scan_ops.static_scan_linear_words_tiles(
        t, arr, dev.width, dev.n, off, flat=False)), mesh)


def sharded_traced_linear_scan(dev: ShardedColumn, keys, mesh: Mesh):
    """Sharded fused linear export for runtime keys (a CUDA tensor, never
    read on the host, or host keys placed on each shard's device), k in
    4/8/12/16: the output contract of :func:`sharded_linear_scan`."""
    _check_column(dev, mesh)
    on = _KeysOn(keys)
    return _split(_run(dev, lambda t, off: scan_ops.bitsliced_scan_linear_words_tiles(
        t, on(t.device), dev.width, dev.n, off, flat=False)), mesh)


def sharded_range_scan(dev: ShardedColumn, lows, highs, mesh: Mesh):
    """Sharded k-range-predicate scan (``scan.range_scan_tiles``) -> (bits
    per shard, counts int64[k], all-reduced)."""
    _check_column(dev, mesh)
    lo_on = _KeysOn(lows, scan_ops._bounds_tensor)
    hi_on = _KeysOn(highs, scan_ops._bounds_tensor)
    return _split(_run(dev, lambda t, off: scan_ops.range_scan_tiles(
        t, lo_on(t.device), hi_on(t.device), dev.width, dev.n, off)), mesh)


def _pair_run(pdev: ShardedColumn, mdev: ShardedColumn, fn) -> list:
    return [fn(p, m, pdev.block_offset(i)) for i, (p, m) in enumerate(zip(pdev.shards,
                                                                          mdev.shards))]


def sharded_aggregate_scan(pdev: ShardedColumn, mdev: ShardedColumn, keys, mesh: Mesh):
    """Fused filter + aggregate over two sharded columns of the same n ->
    (sums numpy uint64[k], counts int64[k]), both all-reduced.

    The single-device tier dispatch (``aggregate.pick_aggregate_tier``):
    host keys take the static bit-plane or the compare kernel, CUDA-tensor
    keys (never read on the host) the runtime bit-plane or the compare
    kernel."""
    _check_pair(pdev, mdev, mesh)
    widths = (pdev.width, mdev.width, pdev.n)
    if _is_runtime_keys(keys):
        keys = scan_ops._runtime_keys(keys)
        bitplane = agg_ops.pick_aggregate_tier(pdev.width, mdev.width, keys) == "bitplane"
        tile_fn = agg_ops.aggregate_bitplane_tiles if bitplane else agg_ops.aggregate_scan_tiles
        on = _KeysOn(keys)

        def fn(p, m, off):
            return tile_fn(p, m, on(p.device), *widths, off)
    else:
        arr = scan_ops._host_keys(keys)
        if agg_ops.pick_aggregate_tier(pdev.width, mdev.width, arr) == "bitplane":
            def fn(p, m, off):
                return agg_ops.aggregate_bitplane_static_tiles(p, m, arr, *widths, off)
        else:
            on = _KeysOn(arr, scan_ops._bounds_tensor)

            def fn(p, m, off):
                return agg_ops.aggregate_scan_tiles(p, m, on(p.device), *widths, off)
    outs = _pair_run(pdev, mdev, fn)
    counts = _reduce([c for c, _ in outs], mesh)
    sums = _reduce([s for _, s in outs], mesh)
    return sums.cpu().numpy().astype(np.uint64), counts


def sharded_minmax_scan(pdev: ShardedColumn, mdev: ShardedColumn, keys, mesh: Mesh):
    """Fused per-key MIN/MAX over two sharded columns -> (mins, maxs,
    counts), int64[k] each, all-reduced; an empty group reports min 2^wm
    and max 0.  Keys may be host keys or a CUDA tensor (not read on the
    host)."""
    _check_pair(pdev, mdev, mesh)
    on = _KeysOn(keys if _is_runtime_keys(keys) else scan_ops._host_keys(keys),
                 scan_ops._bounds_tensor)
    outs = _pair_run(pdev, mdev, lambda p, m, off: agg_ops.minmax_scan_tiles(
        p, m, on(p.device), pdev.width, mdev.width, pdev.n, off))
    counts = _reduce([c for c, _, _ in outs], mesh)
    mins = _reduce([lo for _, lo, _ in outs], mesh, "min")
    maxs = _reduce([hi for _, _, hi in outs], mesh, "max")
    return mins, maxs, counts


def sharded_histogram(dev: ShardedColumn, mesh: Mesh, lo=0, k: int | None = None) -> torch.Tensor:
    """Counts-only value histogram of keys lo..lo+k-1 over a sharded
    column -> int64[k], all-reduced (default the full domain, capped at
    4096).  An int ``lo`` takes ``scan.histogram_dag_tiles``, as the
    single-device dispatch does; a tensor ``lo`` the runtime-lo kernel."""
    _check_column(dev, mesh)
    if k is None:
        k = min(1 << dev.width, scan_ops.MAX_HISTOGRAM_KEYS)
    if isinstance(lo, torch.Tensor):
        def fn(t, off):
            return scan_ops.histogram_tiles(t, lo.to(t.device), k, dev.width, dev.n, off)
    else:
        lo = int(lo)

        def fn(t, off):
            return scan_ops.histogram_dag_tiles(t, lo, k, dev.width, dev.n, off)
    return _reduce(_run(dev, fn), mesh)


def _sharded_domain_histogram(dev: ShardedColumn, mesh: Mesh) -> torch.Tensor:
    """Counts of every value of a 13..20-bit sharded column -> int64[2^w],
    all-reduced: one domain-histogram launch a shard."""
    _check_column(dev, mesh)
    return _reduce(_run(dev, lambda t, off: scan_ops._histogram_domain_tiles(
        t, dev.width, dev.n, off)), mesh)


def sharded_member_scan(dev: ShardedColumn, keys, mesh: Mesh):
    """IN-list membership scan over a sharded column -> (bits, a list of
    int32[B1/S, 128] per shard; int64 count, all-reduced).  The
    single-device dispatch (``member.member_scan_tiles``): host keys by
    ``member_dispatch_tier``, CUDA-tensor keys by the runtime rule."""
    _check_column(dev, mesh)
    if _is_runtime_keys(keys):
        on = _KeysOn(scan_ops._runtime_keys(keys))

        def fn(t, off):
            return member_ops.member_scan_tiles(t, on(t.device), dev.width, dev.n, off)
    else:
        arr = scan_ops._host_keys(keys)

        def fn(t, off):
            return member_ops.member_scan_tiles(t, arr, dev.width, dev.n, off)
    return _split(_run(dev, fn), mesh)


def sharded_conj_range_scan(devs, lows, highs, mesh: Mesh):
    """Fused AND of one range predicate a column over identically sharded
    columns of one table -> (bits, a list of int32[B1/S, 128] per shard;
    int64 count, all-reduced).  See ``ops.conj`` for the kernel."""
    devs = list(devs)
    n = devs[0].n
    for d in devs:
        _check_column(d, mesh)
        if d.n != n:
            raise ValueError(f"conjunction columns must share n, got {d.n} != {n}")
    widths = tuple(d.width for d in devs)
    outs = [conj_ops.conj_range_scan_tiles(tuple(d.shards[i] for d in devs), lows, highs, widths,
                                           n, devs[0].block_offset(i))
            for i in range(len(mesh.devices))]
    return _split(outs, mesh)


def sharded_masked_aggregate(mdev: ShardedColumn, bits, mesh: Mesh):
    """SUM and COUNT of a sharded measure column over sharded match bits
    (a list of int32[B1/S, 128] per shard, e.g. from
    ``query.evaluate_sharded``) -> (sum numpy uint64, int64 count),
    both all-reduced."""
    _check_column(mdev, mesh)
    outs = [agg_ops.masked_aggregate_tiles(t, b, mdev.width, mdev.n)
            for t, b in zip(mdev.shards, bits, strict=True)]
    count = _reduce([c for c, _ in outs], mesh)
    total = _reduce([s for _, s in outs], mesh)
    return np.uint64(int(total)), count


__all__ = [
    "Mesh",
    "ShardedColumn",
    "initialize",
    "make_mesh",
    "shard_column",
    "fetch_global",
    "sharded_shared_scan",
    "sharded_scan",
    "sharded_unpack",
    "sharded_interval_scan",
    "sharded_linear_scan",
    "sharded_static_linear_scan",
    "sharded_traced_linear_scan",
    "sharded_range_scan",
    "sharded_aggregate_scan",
    "sharded_minmax_scan",
    "sharded_histogram",
    "sharded_member_scan",
    "sharded_conj_range_scan",
    "sharded_masked_aggregate",
]
