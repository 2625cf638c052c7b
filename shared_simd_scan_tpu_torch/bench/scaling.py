"""Multi-device scaling benchmark: the sharded shared scan over meshes of
1, 2, 4, ... devices.

PyTorch counterpart of ``shared_simd_scan_tpu/bench/scaling.py``.  The
per-device shard size is held constant (weak scaling: a bigger mesh scans
a bigger column in the same time).  Each mesh size prints a result line
(``harness.print_result``: the time of one sharded call, CUDA events
over a chain of calls, and its bytes a second against the devices'
summed data-sheet rate) and the efficiency against the 1-device row;
then the verification: every mesh's counts against their closed form.

The keys are a CUDA tensor, the counterpart of the JAX chain's traced
keys: the sharded scan takes the runtime tier, the bit-sliced kernel
where ``_bitsliced_wins`` (k >= 5 at width 9), else the compare kernel.

Under ``dist.initialize`` every process of the group calls it: the rows
walk the group's global slots (rank-major, each process's devices in
order), as the JAX bench walks ``jax.devices()`` across processes.  Each
row's mesh carries a subgroup of the processes that hold its slots
(``torch.distributed.new_group``, made in every process in the same
order, destroyed after the row), so its all-reduce is timed; the other
processes wait at a barrier.
A size at which those processes would hold unequal numbers of slots is
skipped.  Process 0 prints.  A 1-device machine prints the single
1-device row.  The JAX package's ``tier="xla"`` form is not here: the port
has no plain-XLA tier.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from shared_simd_scan_tpu_torch import layout
from shared_simd_scan_tpu_torch.bench import harness
from shared_simd_scan_tpu_torch.bench.timing import measure_loop
from shared_simd_scan_tpu_torch.ops import unpack as unpack_ops
from shared_simd_scan_tpu_torch.parallel import dist


def chain_sharded_shared_scan(keys, k, *, sdev, mesh):
    """k sharded shared scans back to back -> the last call's first count."""
    for _ in range(k):
        _, counts = dist.sharded_shared_scan(sdev, keys, mesh)
    return counts[0]


def _expected_counts(n: int, k: int, width: int) -> list[int]:
    """Counts of keys 0..k-1 in ``harness.synth_modk(n, k, width)``, the
    corpus i % k % m (m = min(512, 2^width)): key j < m counts the indices
    i with i % k = r for each r < k with r % m = j."""
    m = min(512, 1 << width)
    return [sum((n - 1 - r) // k + 1 for r in range(j, min(k, n), m)) if j < m else 0
            for j in range(k)]


def _rows(devices: list) -> list:
    """[(mesh size, this process's devices in the row, the ranks holding
    the row's slots)] for the sizes 1, 2, 4, ... up to every slot: without
    a process group this process's devices (and no ranks); under one every
    process's, rank-major (no devices in the processes outside the row)."""
    if not tdist.is_initialized():
        counts, rank = [len(devices)], 0
    else:
        counts, rank = [None] * tdist.get_world_size(), tdist.get_rank()
        tdist.all_gather_object(counts, len(devices))
    rows, nd = [], 1
    while nd <= sum(counts):
        held, first = [], 0
        for c in counts:
            held.append(min(max(nd - first, 0), c))
            first += c
        members = [r for r, h in enumerate(held) if h]
        if len({held[r] for r in members}) == 1:
            rows.append((nd, devices[:held[rank]],
                         members if tdist.is_initialized() else None))
        nd *= 2
    return rows


def bench_scaling(
    per_device_data_size: int = 64 * 1024 * 1024,
    reps: int = 3,
    k: int = 8,
    width: int = harness.DEFAULT_WIDTH,
    *,
    devices=None,
):
    """Weak scaling of the sharded shared scan over the first 1, 2, 4, ...
    slots of ``devices`` (default: ``dist.make_mesh()``'s; CPU devices time
    the plain versions on the host clock, for the tests), across every
    process of the group under ``dist.initialize`` -> [(devices, bytes/s,
    efficiency)] of the rows this process took part in."""
    if devices is None:
        devices = dist.make_mesh().devices
    devices = [torch.device(d) for d in devices]
    roof1 = harness._roof(devices[0])
    grouped = tdist.is_initialized()
    lead = not grouped or tdist.get_rank() == 0  # a member of every row

    base_bps = None
    results, verified = [], True
    for nd, local, members in _rows(devices):
        # every process makes the row's subgroup, in the same order
        group = tdist.new_group(members) if grouped else None
        if local:
            mesh = dist.Mesh(tuple(local), group)
            n = harness.values_for(per_device_data_size * nd, width)
            # set-up (not timed): packed on the first device, then sharded
            dev = unpack_ops.pack_device_kernel(
                harness.synth_modk(n, k, width, device=local[0]), width)
            sdev = dist.shard_column(dev, mesh)
            del dev
            keys = torch.arange(k, dtype=torch.int32, device=local[0])
            traffic = layout.packed_nbytes(width, n) + k * layout.bitvector_words(n) * 4
            meas = measure_loop(
                lambda keys, iters: chain_sharded_shared_scan(keys, iters, sdev=sdev, mesh=mesh),
                (keys,), trials=max(2, reps),
                # the most launches any process of the row asks for
                agree=lambda iters: int(dist._reduce(
                    [torch.tensor([iters], device=local[0])], mesh, "max")))
            bps = traffic / meas.seconds
            if base_bps is None:
                base_bps = bps
            eff = bps / (base_bps * nd)
            if lead:
                res = harness.BenchResult(f"sharded shared scan k={k} on {nd} device(s)", meas,
                                          traffic)
                harness.print_result(res, roof1 * nd if roof1 else None)
                print(f"    scaling efficiency vs 1 device: {100 * eff:.1f}%")
            results.append((nd, bps, eff))
            _, counts = dist.sharded_shared_scan(sdev, keys, mesh)
            verified &= counts.tolist() == _expected_counts(n, k, width)
            del sdev
        if grouped:
            tdist.barrier()
            # a subgroup holds a communicator (under NCCL, on the card): one a row
            tdist.destroy_process_group(group)
    if lead:
        print("    verification:", "ok" if verified else "FAILED")
    return results
