"""Multi-process collective demo: the sharded scan surface over real
cross-process collectives.

PyTorch counterpart of ``scripts/run_multiproc_demo.py``.  It runs in one
of two forms.

Spawned (the default): the parent spawns ``--nproc`` processes that join
one gloo process group through a ``file://`` rendezvous in a temporary
directory (no port to pick); each owns ``--devs-per-proc`` CPU shards, so
the mesh spans processes and shards within a process, and counts are
reduced across both.

Under a launcher (``RANK`` and ``WORLD_SIZE`` in the environment, as
``torchrun`` sets them): this process is one rank of that group.  It calls
``dist.initialize()`` (the ``env://`` form; NCCL, bound to card
``LOCAL_RANK``) and ``dist.make_mesh()`` (that card alone), so the mesh
holds one shard a rank.  ``--device=cpu`` makes it a gloo rank of one CPU
shard.  Each rank prints one line, ``multiproc rank {json}``: its
``LOCAL_RANK``, ``torch.cuda.current_device()``, the mesh's devices, the
backend and the host-clock ms of each set (synchronized, median of
``REPS`` calls after a warm-up).  ``--scaling=BYTES`` then runs
``bench_scaling`` over the group at BYTES a slot: rank 0 prints its rows
and verification, and each rank's line lists the mesh sizes it took part
in.

Every process builds the same columns from one seed: the main path's
9-bit ``i % 8`` column and a table of ``price`` (9 bits), ``region`` (5),
``status`` (4) and ``revenue`` (20) drawn from a generator seeded 0 on the
process's device.  Each set's sharded result is held bit for bit against
the same process's unsharded call on the same device, and, up to
``NUMPY_MAX_N`` values, its counts, sums, minima and maxima against numpy:

- X1, X2: the shared scan on keys 0..7 (interval) and key 3 (compare);
- S8, M8: eight spread keys of ``price`` (static tier), and as an IN-list;
- Q1-Q4: ``query_trees``' WHERE clauses (``query.evaluate_sharded``); Q3
  is a NOT, whose complement re-masks the padding after the last value,
  which lies in the last shard (the last rank's);
- A1: the masked SUM/COUNT of ``revenue`` over Q1's bits;
- A2, A3: keyed SUM/COUNT of ``revenue`` by ``region`` 0..31 and by
  ``price`` 3; A6: keyed MIN/MAX/COUNT by ``region`` 0..7.

The sets (``sets``, ``query_trees``, ``query_truth``) are defined here
once; ``chip_smoke.py`` runs them, and more, on its sharded meshes.

Usage:
    python -m shared_simd_scan_tpu_torch.parallel.multiproc_demo [--nproc=2] [--devs-per-proc=2]
    torchrun --nproc_per_node=N -m shared_simd_scan_tpu_torch.parallel.multiproc_demo \\
        [--values=N] [--device=cpu] [--scaling=BYTES]

``--values=N`` sets the column's value count (default: 8 tiles a shard
and a ragged tail).  It is not spelled ``--n=``: torchrun's argument
parser takes that for an abbreviation of its own ``--nnodes``,
``--nproc-per-node``, ... and refuses it.

Exit 0 when every process verified: the spawned form prints ``multiproc
demo: OK``, each launched rank ``"ok": true`` in its line.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH, K, SCAN_KEY = 9, 8, 3
TABLE = {"price": 9, "region": 5, "status": 4, "revenue": 20}
SPREAD = [(i * 97 + 5) % (1 << WIDTH) for i in range(8)]
AGG_KEYS = {"A2": list(range(32)), "A3": [3], "A6": list(range(8))}
NUMPY_MAX_N = 1 << 22  # past it, each set is held against its unsharded call alone
REPS = 10  # timed calls a set, after the warm-up


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def columns(n: int, device) -> tuple[dict, dict]:
    """(packed DeviceColumns, raw int32 values) of the demo's columns on
    ``device``: ``main`` is ``i % 8`` at 9 bits, the table's columns are
    drawn in TABLE's order from one generator seeded 0."""
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import unpack

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    raw = {"main": harness.synth_modk(n, K, WIDTH, device=device)}
    widths = {"main": WIDTH, **TABLE}
    for name, w in TABLE.items():
        raw[name] = torch.randint(0, 1 << w, (n,), generator=gen, device=device,
                                  dtype=torch.int32)
    return {name: unpack.pack_device_kernel(v, widths[name]) for name, v in raw.items()}, raw


def query_trees(q, c) -> dict:
    """WHERE clauses over the table's columns ``c`` (``q``: the query module)."""
    return {
        # the analytics demo's WHERE: conj m=2 and the member window tier
        "Q1": q.And(q.Range(c["price"], 100, 400), q.Range(c["region"], 2, 10),
                    q.Or(q.In(c["status"], [1, 4, 9]), q.Eq(c["status"], 0))),
        # the range scan at k=3 and the member interval tier (one range)
        "Q2": q.Or(q.Range(c["price"], 0, 50), q.Range(c["price"], 300, 350),
                   q.Range(c["price"], 500, 512), q.Eq(c["region"], 7)),
        # conj m=3 under a complement that re-masks the tail
        "Q3": q.Not(q.And(q.Eq(c["price"], 3), q.Eq(c["region"], 4), q.Eq(c["status"], 5))),
        # two windows of a 4-bit column cost more than its table: the domain tier
        "Q4": q.In(c["status"], [1, 4, 9, 0, 40]),
    }


def query_truth(name: str, r: dict):
    """The mask of ``query_trees``' ``name`` on the raw values ``r``: numpy
    arrays or tensors alike (comparisons and boolean operators only)."""
    p, g, s = r["price"], r["region"], r["status"]
    if name == "Q1":
        return ((p >= 100) & (p < 400) & (g >= 2) & (g < 10)
                & ((s == 1) | (s == 4) | (s == 9) | (s == 0)))
    if name == "Q2":
        return (p < 50) | ((p >= 300) & (p < 350)) | (p >= 500) | (g == 7)
    if name == "Q3":
        return ~((p == 3) & (g == 4) & (s == 5))
    return (s == 1) | (s == 4) | (s == 9) | (s == 0) | (s == 40)


def same_scan(n: int):
    """Whether a sharded (bits, counts) ``s`` over mesh ``m`` equals the
    unsharded ``u`` of an n-value column, bit for bit."""
    from shared_simd_scan_tpu_torch.ops import scan
    from shared_simd_scan_tpu_torch.parallel import dist

    return lambda u, s, m: (torch.equal(scan.bits_to_canonical(dist.fetch_global(s[0], m), n),
                                        u[0])
                            and torch.equal(s[1], u[1]))


def sets(n: int) -> dict:
    """Set -> (what it runs, the unsharded call on columns ``c``, the
    sharded call on sharded columns ``c`` over mesh ``m`` with ``q1`` this
    mesh's Q1 bits, whether a sharded result ``s`` equals the unsharded
    ``u``, and the numpy check of a result on the raw values ``r``).  A1's
    unsharded call reads Q1's unsharded bits as ``c["q1"]``: Q1 comes
    first."""
    from shared_simd_scan_tpu_torch import query as q
    from shared_simd_scan_tpu_torch.ops import aggregate, member, scan
    from shared_simd_scan_tpu_torch.parallel import dist

    scan_eq = same_scan(n)

    def same_sums(u, s, m):
        return np.array_equal(s[0], u[0].cpu().numpy().astype(np.uint64)) and \
            torch.equal(s[1], u[1])

    def counts(keys, col="main"):
        return lambda r, s: s[1].tolist() == [int((r[col] == key).sum()) for key in keys]

    def total(r, s, sel):
        return int(s[0]) == int(r["revenue"][sel].astype(np.uint64).sum()) \
            and int(s[1]) == int(sel.sum())

    def keyed_sums(col, keys):
        return lambda r, s: all(total(r, (s[0][j], s[1][j]), r[col] == key)
                                for j, key in enumerate(keys))

    def keyed_minmax(r, s):
        for j, key in enumerate(AGG_KEYS["A6"]):
            sel = r["region"] == key
            if int(s[2][j]) != int(sel.sum()) or (sel.any() and (
                    int(s[0][j]) != int(r["revenue"][sel].min())
                    or int(s[1][j]) != int(r["revenue"][sel].max()))):
                return False
        return True

    out = {
        "X1": ("sharded_shared_scan(main, keys 0..7): the interval kernel",
               lambda c: scan.shared_scan_device(c["main"], list(range(K))),
               lambda c, m, q1: dist.sharded_shared_scan(c["main"], list(range(K)), m),
               scan_eq, counts(range(K))),
        "X2": (f"sharded_shared_scan(main, [{SCAN_KEY}]): the compare kernel",
               lambda c: scan.shared_scan_device(c["main"], [SCAN_KEY]),
               lambda c, m, q1: dist.sharded_shared_scan(c["main"], [SCAN_KEY], m),
               scan_eq, counts([SCAN_KEY])),
        "S8": ("sharded_shared_scan(price, 8 spread keys): the static tier",
               lambda c: scan.shared_scan_device(c["price"], SPREAD),
               lambda c, m, q1: dist.sharded_shared_scan(c["price"], SPREAD, m),
               scan_eq, counts(SPREAD, "price")),
        "M8": ("sharded_member_scan(price, S8's keys as an IN-list)",
               lambda c: member.member_scan_device(c["price"], SPREAD),
               lambda c, m, q1: dist.sharded_member_scan(c["price"], SPREAD, m),
               scan_eq, lambda r, s: int(s[1]) == int(np.isin(r["price"], SPREAD).sum())),
    }
    for name in ("Q1", "Q2", "Q3", "Q4"):
        out[name] = (f"evaluate_sharded({name})",
                     lambda c, name=name: q.evaluate(query_trees(q, c)[name]),
                     lambda c, m, q1, name=name: q.evaluate_sharded(query_trees(q, c)[name], m),
                     lambda u, s, m: torch.equal(
                         scan.bits_to_canonical(dist.fetch_global(s[0], m), n), u[0])
                     and int(s[1]) == int(u[1]),
                     lambda r, s, name=name: int(s[1]) == int(query_truth(name, r).sum()))
    out.update({
        "A1": ("sharded_masked_aggregate(revenue, Q1's bits)",
               lambda c: aggregate.masked_aggregate_device(c["revenue"], c["q1"]),
               lambda c, m, q1: dist.sharded_masked_aggregate(c["revenue"], q1, m),
               lambda u, s, m: int(s[0]) == int(u[0]) and int(s[1]) == int(u[1]),
               lambda r, s: total(r, s, query_truth("Q1", r))),
        "A2": ("sharded_aggregate_scan(region, revenue, 0..31): the static bit-plane kernel",
               lambda c: aggregate.aggregate_scan_device(c["region"], c["revenue"],
                                                         AGG_KEYS["A2"]),
               lambda c, m, q1: dist.sharded_aggregate_scan(c["region"], c["revenue"],
                                                            AGG_KEYS["A2"], m),
               same_sums, keyed_sums("region", AGG_KEYS["A2"])),
        "A3": ("sharded_aggregate_scan(price, revenue, [3]): the compare kernel",
               lambda c: aggregate.aggregate_scan_device(c["price"], c["revenue"],
                                                         AGG_KEYS["A3"]),
               lambda c, m, q1: dist.sharded_aggregate_scan(c["price"], c["revenue"],
                                                            AGG_KEYS["A3"], m),
               same_sums, keyed_sums("price", AGG_KEYS["A3"])),
        "A6": ("sharded_minmax_scan(region, revenue, 0..7)",
               lambda c: aggregate.minmax_scan_device(c["region"], c["revenue"],
                                                      AGG_KEYS["A6"]),
               lambda c, m, q1: dist.sharded_minmax_scan(c["region"], c["revenue"],
                                                         AGG_KEYS["A6"], m),
               lambda u, s, m: all(torch.equal(a, b) for a, b in zip(s, u)), keyed_minmax),
    })
    return out


def run_sets(mesh, n: int, device, reps: int = REPS) -> dict:
    """Every set on ``mesh`` (a collective: every process of its group runs
    it) -> set -> host-clock ms of the sharded call (median of ``reps``
    synchronized calls after a warm-up).  Raises on the first result that
    differs from the unsharded call or from numpy."""
    from shared_simd_scan_tpu_torch.parallel import dist

    cols, raw = columns(n, device)
    shards = {name: dist.shard_column(col, mesh) for name, col in cols.items()}
    raw = {name: v.cpu().numpy() for name, v in raw.items()} if n <= NUMPY_MAX_N else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ms, q1 = {}, None
    for name, (_, unsharded, sharded, same, truth) in sets(n).items():
        u = unsharded(cols)
        if name == "Q1":
            cols["q1"] = u[0]
        s = sharded(shards, mesh, q1)
        _check(same(u, s, mesh), f"{name}: the sharded result equals the unsharded call")
        if raw is not None:
            _check(truth(raw, s), f"{name}: the sharded result equals numpy's")
        if name == "Q1":
            q1 = s[0]
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            sharded(shards, mesh, q1)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
    return ms


def child(rank: int, nproc: int, devs: int, init_file: str, n: int | None = None) -> None:
    """One spawned process of the demo: join the group, run every check."""
    torch.set_num_threads(1)
    from shared_simd_scan_tpu_torch.parallel import dist

    dist.initialize(init_method=f"file://{init_file}", world_size=nproc, rank=rank, device="cpu")
    try:
        mesh = dist.make_mesh(["cpu"] * devs)
        nd = mesh.size
        _check(nd == nproc * devs, f"mesh of {nd} shards, expected {nproc} x {devs}")
        if n is None:
            n = nd * 8 * 128 * 32 + 17
        ms = run_sets(mesh, n, torch.device("cpu"), reps=1)
        # one write a line, so the processes' lines do not interleave
        sys.stdout.write(f"proc {rank}/{nproc}: mesh={nd} shards across {nproc} processes "
                         f"({devs}/proc), n={n}, all sharded paths verified (X1 and its "
                         f"all-reduce {ms['X1']:.0f} ms)\n")
        sys.stdout.flush()
    finally:
        torch.distributed.destroy_process_group()


def rank_main(n: int | None, device_arg: str | None, scaling: int | None) -> int:
    """One rank of a launcher's group (RANK, WORLD_SIZE and the rendezvous
    in the environment): bind, build the mesh, run every set (and the
    scaling bench at ``scaling`` bytes a slot), print the rank's line."""
    from shared_simd_scan_tpu_torch.bench import scaling as scaling_bench
    from shared_simd_scan_tpu_torch.ops import _cuda
    from shared_simd_scan_tpu_torch.parallel import dist

    cpu = device_arg == "cpu"
    if cpu:
        torch.set_num_threads(1)
    prebuilt = None if cpu else _cuda.library_path().exists()
    dist.initialize(device="cpu" if cpu else None)
    try:
        mesh = dist.make_mesh(["cpu"] if cpu else None)
        world = torch.distributed.get_world_size()
        _check(mesh.size == world, f"mesh of {mesh.size} shards, one a rank of {world}")
        device = mesh.devices[0]
        if n is None:
            n = mesh.size * 8 * 128 * 32 + 17
        t0 = time.monotonic()
        ms = run_sets(mesh, n, device)
        line = {"rank": torch.distributed.get_rank(), "world_size": world,
                "local_rank": os.environ.get("LOCAL_RANK"),
                "current_device": torch.cuda.current_device() if torch.cuda.is_available()
                else None,
                "mesh": [str(d) for d in mesh.devices], "mesh_size": mesh.size,
                "backend": torch.distributed.get_backend(), "n": n,
                "prebuilt_kernels": prebuilt, "seconds": time.monotonic() - t0, "ms": ms}
        if scaling is not None:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rows = scaling_bench.bench_scaling(scaling, devices=mesh.devices)
            sys.stdout.write(printed.getvalue())
            line["scaling_rows"] = [nd for nd, _, _ in rows]
            if line["rank"] == 0:
                _check("verification: ok" in printed.getvalue(),
                       "bench_scaling's counts equal their closed form")
        line["ok"] = True
        sys.stdout.write(f"multiproc rank {json.dumps(line)}\n")
        sys.stdout.flush()
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv: list[str]) -> int:
    nproc, devs, n, device, scaling = 2, 2, None, None, None
    for a in argv:
        if a.startswith("--nproc="):
            nproc = int(a.split("=", 1)[1])
        elif a.startswith("--devs-per-proc="):
            devs = int(a.split("=", 1)[1])
        elif a.startswith("--values="):
            n = int(a.split("=", 1)[1])
        elif a.startswith("--scaling="):
            scaling = int(a.split("=", 1)[1])
        elif a == "--device=cpu":
            device = "cpu"
        else:
            print(__doc__)
            print(f"error: unknown argument {a!r}", file=sys.stderr)
            return 1
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return rank_main(n, device, scaling)
    import torch.multiprocessing as mp

    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(child, args=(nproc, devs, f"{tmp}/init", n), nprocs=nproc, join=True)
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
