"""Multi-process collective demo: the sharded scan surface over real
cross-process gloo collectives.

PyTorch counterpart of ``scripts/run_multiproc_demo.py``.  The parent
spawns ``--nproc`` processes that join one gloo process group through a
``file://`` rendezvous in a temporary directory (no port to pick); each
owns ``--devs-per-proc`` CPU shards, so the mesh spans processes and
shards within a process, and counts are reduced across both.  Every
process builds the same column from one seed and checks, against numpy:

- the interval shared scan's counts (keys 0..3);
- the spread-key static tier's counts;
- the IN-list member count;
- a composed query (``query.evaluate_sharded``) and the sharded masked
  aggregate over its bits (count and sum), then the keyed SUM/COUNT and
  MIN/MAX.

Usage:
    python -m shared_simd_scan_tpu_torch.parallel.multiproc_demo [--nproc=2] [--devs-per-proc=2]

Exit 0 and ``multiproc demo: OK`` when every process verified.
"""
from __future__ import annotations

import sys
import tempfile
import time

import numpy as np
import torch


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def child(rank: int, nproc: int, devs: int, init_file: str) -> None:
    """One process of the demo: join the group, run every check."""
    torch.set_num_threads(1)
    from shared_simd_scan_tpu_torch import layout
    from shared_simd_scan_tpu_torch import query as q
    from shared_simd_scan_tpu_torch.parallel import dist

    dist.initialize(init_method=f"file://{init_file}", world_size=nproc, rank=rank, device="cpu")
    try:
        mesh = dist.make_mesh(["cpu"] * devs)
        nd = mesh.size
        _check(nd == nproc * devs, f"mesh of {nd} shards, expected {nproc} x {devs}")

        width, k = 9, 4
        n = nd * 8 * 128 * 32 + 17
        rng = np.random.default_rng(0)  # the same column in every process
        vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
        sdev = dist.shard_column(layout.pack_device(vals, width, device="cpu"), mesh)
        keys = np.arange(k, dtype=np.uint32)

        t0 = time.perf_counter()
        _, counts = dist.sharded_shared_scan(sdev, keys, mesh)
        dt = time.perf_counter() - t0
        _check(counts.tolist() == [int((vals == key).sum()) for key in keys], "interval counts")

        skeys = (np.arange(8, dtype=np.uint32) * 97 + 5) % (1 << width)
        _, scounts = dist.sharded_shared_scan(sdev, skeys, mesh)
        _check(scounts.tolist() == [int((vals == key).sum()) for key in skeys],
               "spread-key static tier counts")

        _, mcount = dist.sharded_member_scan(sdev, skeys, mesh)
        _check(int(mcount) == int(np.isin(vals, skeys).sum()), "member count")

        mvals = rng.integers(0, 1 << 16, size=n, dtype=np.uint32)
        smdev = dist.shard_column(layout.pack_device(mvals, 16, device="cpu"), mesh)
        qbits, qcount = q.evaluate_sharded(
            q.And(q.Range(sdev, 1, 200), q.Not(q.Eq(sdev, 7))), mesh)
        total, macount = dist.sharded_masked_aggregate(smdev, qbits, mesh)
        mask = (vals >= 1) & (vals < 200) & (vals != 7)
        _check(int(qcount) == int(macount) == int(mask.sum()), "query and masked counts")
        _check(int(total) == int(mvals[mask].astype(np.uint64).sum()), "masked sum")

        sums, acounts = dist.sharded_aggregate_scan(sdev, smdev, keys, mesh)
        mins, maxs, ccounts = dist.sharded_minmax_scan(sdev, smdev, keys, mesh)
        for j, key in enumerate(keys):
            sel = vals == key
            _check(int(acounts[j]) == int(ccounts[j]) == int(sel.sum()), f"key {key} counts")
            _check(int(sums[j]) == int(mvals[sel].astype(np.uint64).sum()), f"key {key} sum")
            if sel.any():
                _check(int(mins[j]) == int(mvals[sel].min())
                       and int(maxs[j]) == int(mvals[sel].max()), f"key {key} min/max")
        # one write a line, so the processes' lines do not interleave
        sys.stdout.write(f"proc {rank}/{nproc}: mesh={nd} shards across {nproc} processes "
                         f"({devs}/proc), n={n}, all sharded paths verified (first scan and "
                         f"all-reduce {dt * 1e3:.0f} ms)\n")
        sys.stdout.flush()
    finally:
        torch.distributed.destroy_process_group()


def main(argv: list[str]) -> int:
    nproc, devs = 2, 2
    for a in argv:
        if a.startswith("--nproc="):
            nproc = int(a.split("=", 1)[1])
        elif a.startswith("--devs-per-proc="):
            devs = int(a.split("=", 1)[1])
        else:
            print(__doc__)
            print(f"error: unknown argument {a!r}", file=sys.stderr)
            return 1
    import torch.multiprocessing as mp

    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(child, args=(nproc, devs, f"{tmp}/init"), nprocs=nproc, join=True)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            print(f"FAILED: {e}", flush=True)
            rc = 1
    print("multiproc demo:", "OK" if rc == 0 else "FAILED", flush=True)
    return rc


if __name__ == "__main__":
    # the package module's main, so the spawned children unpickle ``child``
    # from the package, not from this script's __main__
    from shared_simd_scan_tpu_torch.parallel.multiproc_demo import main as _main

    sys.exit(_main(sys.argv[1:]))
