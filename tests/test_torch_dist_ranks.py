"""One process a card: ``parallel.dist``'s binding of a launcher's rank to
its card (``LOCAL_RANK``), the scaling bench over a process group, and the
multi-process demo under ``torch.distributed.run``.

The binding is tested with ``torch.cuda`` and ``torch.distributed``
stubbed: a host of 4 cards, this process rank 2 of a group of 4.  The
layout of one shard a rank is held against the JAX package's 4-device
virtual mesh (tests/conftest.py) through ``shard_column``, and the ranks'
partial counts against the port's unsharded scan.  The process-group
tests run real gloo processes on the CPU.
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.parallel import dist as jdist
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import scan as tscan
from shared_simd_scan_tpu_torch.parallel import dist as tdist

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CARDS, WORLD, RANK = 4, 4, 2
WORLD_GROUP = object()  # the stubbed default process group


@pytest.fixture
def host(monkeypatch):
    """A stubbed host of CARDS cards and a group of WORLD processes, this
    one RANK; records set_device and init_process_group calls."""
    calls = types.SimpleNamespace(set_device=[], init=[], cards=CARDS, rank=RANK)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: calls.cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: calls.cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.set_device.append(torch.device(d).index))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: calls.set_device[-1] if calls.set_device else 0)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.init.append((backend, kw)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "group", types.SimpleNamespace(WORLD=WORLD_GROUP))
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: WORLD)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: calls.rank)
    return calls


@pytest.mark.parametrize("local_rank", [0, 2])
def test_local_rank_binds_its_card(host, monkeypatch, local_rank):
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    tdist.initialize()
    assert host.set_device == [local_rank]
    assert host.init == [("nccl", {"init_method": None, "world_size": -1, "rank": -1})]
    assert torch.cuda.current_device() == local_rank
    mesh = tdist.make_mesh()
    assert mesh.devices == (torch.device("cuda", local_rank),)
    assert mesh.group is WORLD_GROUP
    assert mesh.size == mesh.world_size == WORLD
    assert mesh.shard_index(0) == mesh.rank == RANK


def test_no_local_rank_drives_every_local_card(host):
    tdist.initialize()
    assert host.set_device == []  # the current card, as before
    assert host.init[0][0] == "nccl"
    mesh = tdist.make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(CARDS))
    assert mesh.size == CARDS * WORLD
    assert [mesh.shard_index(i) for i in range(CARDS)] == [RANK * CARDS + i for i in range(CARDS)]


@pytest.mark.parametrize("call", ["initialize", "make_mesh"])
def test_local_rank_past_the_cards_is_refused(host, monkeypatch, call):
    monkeypatch.setenv("LOCAL_RANK", str(CARDS))
    with pytest.raises(ValueError, match=rf"LOCAL_RANK={CARDS}.*device_count\(\) is {CARDS}"):
        getattr(tdist, call)()
    assert host.set_device == [] and host.init == []


@pytest.mark.parametrize("local_rank", [None, "0"])
@pytest.mark.parametrize("call", ["initialize", "make_mesh"])
def test_no_card_raises_with_no_cpu_fallback(host, monkeypatch, call, local_rank):
    host.cards = 0
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tdist, call)()
    assert host.set_device == [] and host.init == []


@pytest.mark.parametrize("local_rank", ["1", str(CARDS)])
def test_explicit_device_wins_over_local_rank(host, monkeypatch, local_rank):
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    tdist.initialize(init_method="tcp://localhost:1", world_size=WORLD, rank=RANK,
                     device="cuda:3")
    assert host.set_device == [3]
    assert host.init == [("nccl", {"init_method": "tcp://localhost:1", "world_size": WORLD,
                                   "rank": RANK})]
    mesh = tdist.make_mesh(["cuda:3", "cuda:0"])
    assert mesh.devices == (torch.device("cuda", 3), torch.device("cuda", 0))
    assert tdist.make_mesh(["cpu"] * 8).size == 8 * WORLD


@pytest.mark.parametrize("local_rank", [None, "1", str(CARDS)])
def test_cpu_device_stays_on_gloo(host, monkeypatch, local_rank):
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    tdist.initialize(device="cpu")
    assert host.set_device == []
    assert host.init[0][0] == "gloo"


@pytest.mark.parametrize("n", [70_003, 4 * 8 * 128 * 32])
def test_one_shard_a_rank_matches_the_jax_four_device_mesh(host, monkeypatch, n):
    """Four ranks of one card each cut the column as the JAX 4-device mesh
    does; their partial counts (the all-reduce stubbed out) sum to the
    unsharded scan's."""
    vals = np.random.default_rng(3).integers(0, 1 << 9, n, dtype=np.uint64).astype(np.uint32)
    jdev = jlayout.to_device(jlayout.pack(vals, 9))
    jsd = jdist.shard_column(jdev, jdist.make_mesh(jax.devices()[:4]))
    tdev = tlayout.from_jax_numpy(9, n, np.asarray(jdev.tiles), "cpu")
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, op=None, group=None: None)
    keys = [0, 3, 7, 300, 511]
    ubits, ucounts = tscan.shared_scan_device(tdev, keys)
    shards, bits, counts = [], [], torch.zeros(len(keys), dtype=torch.int64)
    for rank in range(WORLD):
        host.rank = rank
        mesh = tdist.Mesh(("cpu",), WORLD_GROUP)
        sd = tdist.shard_column(tdev, mesh)
        assert sd.b1 == jsd.tiles.shape[1] and sd.local_b1 * WORLD == sd.b1
        assert mesh.shard_index(0) == rank and sd.block_offset(0) == rank * sd.local_b1 * 128
        shards.append(sd.shards[0])
        rank_bits, rank_counts = tdist.sharded_shared_scan(sd, keys, mesh)
        bits.append(rank_bits[0])
        counts += rank_counts
    np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy().view(np.uint32),
                                  np.asarray(jsd.tiles))
    assert torch.equal(tscan.bits_to_canonical(torch.cat(bits, dim=-2), n), ubits)
    assert torch.equal(counts, ucounts)


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return env


SCALING_RANK = """
import sys
import torch
from shared_simd_scan_tpu_torch.bench import scaling
from shared_simd_scan_tpu_torch.parallel import dist

torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.initialize(init_method="file://" + sys.argv[2], world_size=2, rank=rank, device="cpu")
try:
    rows = scaling.bench_scaling(16 * 1024, 2, 8, 9, devices=["cpu"] * 2)
    print("rows", rank, [nd for nd, _, _ in rows], flush=True)
    # each row's subgroup was destroyed after its row: the default group is left
    print("groups", rank, len(torch.distributed.distributed_c10d._world.pg_map), flush=True)
finally:
    torch.distributed.destroy_process_group()
"""


def test_scaling_bench_over_two_gloo_processes(tmp_path):
    """Two processes of two CPU shards each: rows over the 4 global slots,
    each row's mesh on a subgroup of the processes holding its slots."""
    procs = [subprocess.Popen([sys.executable, "-c", SCALING_RANK, str(rank),
                               str(tmp_path / "rendezvous")], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    out0, out1 = outs[0][0], outs[1][0]
    for nd in (1, 2, 4):
        assert out0.count(f"* sharded shared scan k=8 on {nd} device(s)") == 1
    assert "verification: ok" in out0
    assert "rows 0 [1, 2, 4]" in out0
    assert "groups 0 1" in out0 and "groups 1 1" in out1
    # rank 1 holds slots of the 4-slot row alone, and prints nothing of its own
    assert "rows 1 [4]" in out1 and "sharded shared scan" not in out1


def test_multiproc_demo_under_torchrun_on_two_gloo_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "shared_simd_scan_tpu_torch.parallel.multiproc_demo", "--device=cpu",
         "--values=70003", "--scaling=16384"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    tag = "multiproc rank "  # a launcher may prefix a worker's lines
    lines = [json.loads(line.split(tag, 1)[1]) for line in out.stdout.splitlines() if tag in line]
    assert sorted(r["rank"] for r in lines) == [0, 1]
    for r in lines:
        assert r["ok"] and r["mesh_size"] == 2 and r["mesh"] == ["cpu"]
        assert r["backend"] == "gloo" and r["local_rank"] == str(r["rank"])
        assert r["n"] == 70_003
        assert set(r["ms"]) == {"X1", "X2", "S8", "M8", "Q1", "Q2", "Q3", "Q4", "A1", "A2",
                                "A3", "A6"}
        assert r["scaling_rows"] == ([1, 2] if r["rank"] == 0 else [2])
    # bench_scaling's rows and verification, printed by rank 0 alone
    for nd in (1, 2):
        assert out.stdout.count(f"* sharded shared scan k=8 on {nd} device(s)") == 1
    assert out.stdout.count("verification: ok") == 1
