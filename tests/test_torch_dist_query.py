"""The port's sharded query, statistics and FOR query (``query.evaluate_sharded``,
``stats(..., mesh=)``, ``forcol.normalize`` over a sharded column), its
sharded masked aggregate, and the multi-process gloo demo.

As in test_torch_dist.py: the JAX package on its virtual 8-device CPU mesh
in interpret mode, the port on ``make_mesh(["cpu"] * 8)``, one table from a
numpy seed (three columns of the analytics demo's widths and a 16-bit
measure) at n = 70,003, whose ragged end lies inside shard 2 of 8.  Every
comparison is exact integer equality.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import forcol as jforcol
from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu import query as jq
from shared_simd_scan_tpu import stats as jstats
from shared_simd_scan_tpu.parallel import dist as jdist
from shared_simd_scan_tpu_torch import forcol as tforcol
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch import query as tq
from shared_simd_scan_tpu_torch import stats as tstats
from shared_simd_scan_tpu_torch.ops import aggregate as tagg
from shared_simd_scan_tpu_torch.ops import scan as tscan
from shared_simd_scan_tpu_torch.parallel import dist as tdist

torch.set_num_threads(1)

N = 70_003
WIDTHS = {"price": 9, "region": 5, "status": 4, "revenue": 16}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.fixture(scope="module")
def meshes():
    return jdist.make_mesh(), tdist.make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def table(meshes):
    """name -> (values, port column, JAX sharded column, port sharded
    column)."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(11)
    out = {}
    for name, width in WIDTHS.items():
        vals = rng.integers(0, 1 << width, N, dtype=np.uint64).astype(np.uint32)
        jdev = jlayout.to_device(jlayout.pack(vals, width))
        tdev = tlayout.from_jax_numpy(width, N, np.asarray(jdev.tiles), "cpu")
        out[name] = (vals, tdev, jdist.shard_column(jdev, jmesh), tdist.shard_column(tdev, tmesh))
    return out


def _cols(table, which: int) -> dict:
    return {name: entry[which] for name, entry in table.items()}


def _tree(q, c):
    """A conjunction with a complement and an IN-list, or'ed with a
    multi-range column and the complement of an empty And."""
    return q.Or(
        q.And(q.Range(c["price"], 100, 400), q.Not(q.Eq(c["region"], 3)),
              q.In(c["status"], [1, 4, 9])),
        q.Range(c["price"], 0, 10), q.Range(c["price"], 500, 512), q.Not(q.And()))


def _truth(v) -> np.ndarray:
    p, g, s = v["price"], v["region"], v["status"]
    return (((p >= 100) & (p < 400) & (g != 3) & np.isin(s, [1, 4, 9]))
            | (p < 10) | (p >= 500))


def test_evaluate_sharded_and_masked_aggregate_match_the_jax_mesh(meshes, table):
    jmesh, tmesh = meshes
    values = _cols(table, 0)
    jbits, jcount = jq.evaluate_sharded(_tree(jq, _cols(table, 2)), jmesh, interpret=True)
    tbits, tcount = tq.evaluate_sharded(_tree(tq, _cols(table, 3)), tmesh)
    assert len(tbits) == 8 and all(tuple(b.shape) == (8, 128) for b in tbits)
    np.testing.assert_array_equal(_u32(tdist.fetch_global(tbits, tmesh)), np.asarray(jbits))
    truth = _truth(values)
    assert int(tcount) == int(jcount) == int(truth.sum())
    ubits, ucount = tq.evaluate(_tree(tq, _cols(table, 1)))
    assert bool((tscan.bits_to_canonical(tdist.fetch_global(tbits, tmesh), N) == ubits).all())
    assert int(ucount) == int(tcount)

    jsm = table["revenue"][2]
    jsum, jmcount = jdist.sharded_masked_aggregate(jsm, jbits, jmesh, interpret=True)
    tsum, tmcount = tdist.sharded_masked_aggregate(table["revenue"][3], tbits, tmesh)
    assert isinstance(tsum, np.uint64) and tsum == jsum
    assert int(tmcount) == int(jmcount) == int(truth.sum())
    assert int(tsum) == int(values["revenue"][truth].astype(np.uint64).sum())
    usum, _ = tagg.masked_aggregate_device(table["revenue"][1], ubits)
    assert int(usum) == int(tsum)


@pytest.mark.parametrize("build", [
    lambda q, c: q.Not(q.And(q.Eq(c["price"], 3), q.Eq(c["region"], 4), q.Eq(c["status"], 5))),
    lambda q, c: q.Or(q.Range(c["price"], 0, 50), q.Range(c["price"], 300, 350),
                      q.Range(c["price"], 500, 512), q.Eq(c["region"], 7)),
    lambda q, c: q.And(q.In(c["status"], []), q.Range(c["price"], 0, 512)),
    lambda q, c: q.And(q.Not(q.Or()), q.Not(q.Range(c["region"], 4, 5))),
    lambda q, c: q.In(c["price"], list(range(0, 512, 3))),
], ids=["not-and", "or-ranges", "empty-in", "not-empty-or-and-not", "in-spread"])
def test_evaluate_sharded_equals_evaluate(meshes, table, build):
    _, tmesh = meshes
    bits, count = tq.evaluate_sharded(build(tq, _cols(table, 3)), tmesh)
    ubits, ucount = tq.evaluate(build(tq, _cols(table, 1)))
    words = tdist.fetch_global(bits, tmesh)
    assert bool((tscan.bits_to_canonical(words, N) == ubits).all()) and int(count) == int(ucount)
    # padding blocks stay zero, a complement's included
    assert not bool(words.reshape(-1)[(N + 31) // 32:].any())


@pytest.mark.parametrize("n", [8 * 8 * 128 * 32, 3 * 8 * 128 * 32, 3 * 8 * 128 * 32 + 1])
def test_complement_at_shard_edges(meshes, n):
    """NOT where n fills every shard, ends at a shard's last word, or puts
    a one-value tail word first in a shard."""
    _, tmesh = meshes
    vals = np.random.default_rng(n).integers(0, 32, n, dtype=np.uint64).astype(np.uint32)
    dev = tlayout.pack_device(vals, 5, device="cpu")
    sdev = tdist.shard_column(dev, tmesh)
    for build in (lambda c: tq.Not(tq.Range(c, 3, 20)),
                  lambda c: tq.And(tq.Not(tq.And()), tq.Range(c, 0, 32))):
        bits, count = tq.evaluate_sharded(build(sdev), tmesh)
        ubits, ucount = tq.evaluate(build(dev))
        words = tdist.fetch_global(bits, tmesh)
        assert bool((tscan.bits_to_canonical(words, n) == ubits).all())
        assert int(count) == int(ucount)
        assert not bool(words.reshape(-1)[(n + 31) // 32:].any())


def test_evaluate_sharded_refuses_mixed_shardings(meshes, table):
    _, tmesh = meshes
    other = tdist.shard_column(table["price"][1], tdist.make_mesh(["cpu"] * 4))
    with pytest.raises(ValueError):
        tq.evaluate_sharded(tq.And(tq.Eq(table["region"][3], 1), tq.Eq(other, 2)), tmesh)
    with pytest.raises(TypeError):
        tq.evaluate_sharded(tq.Eq(table["region"][1], 1), tmesh)


@pytest.mark.parametrize("width", [4, 13])
def test_stats_with_mesh(meshes, width):
    _, tmesh = meshes
    vals = np.random.default_rng(width).integers(0, 1 << width, N, dtype=np.uint64)
    vals = vals.astype(np.uint32)
    jdev = jlayout.to_device(jlayout.pack(vals, width))
    tdev = tlayout.from_jax_numpy(width, N, np.asarray(jdev.tiles), "cpu")
    sdev = tdist.shard_column(tdev, tmesh)
    counts = tstats.histogram_full(sdev, mesh=tmesh)
    assert counts.dtype == np.uint64
    np.testing.assert_array_equal(counts, tstats.histogram_full(tdev))
    np.testing.assert_array_equal(counts, np.bincount(vals, minlength=1 << width))
    if width <= 12:  # the JAX package's one window; its 13-bit windows are in test_torch_stats
        np.testing.assert_array_equal(counts, jstats.histogram_full(jdev, interpret=True))
    assert tstats.describe(sdev, mesh=tmesh) == tstats.describe(tdev)
    qs = [0.0, 0.25, 0.5, 0.9, 1.0]
    np.testing.assert_array_equal(tstats.quantiles(sdev, qs, mesh=tmesh),
                                  tstats.quantiles(tdev, qs))
    for a, b in zip(tstats.topk_values(sdev, 5, mesh=tmesh), tstats.topk_values(tdev, 5)):
        np.testing.assert_array_equal(a, b)


def test_sharded_for_query(meshes):
    """The JAX package's sharded FOR query (tests/test_forcol.py): a
    ForColumn over a sharded offset column, rewritten by normalize."""
    _, tmesh = meshes
    n = 8 * 32 * 128 * 8 + 11
    vals = np.random.default_rng(9).integers(40_000, 40_400, n, dtype=np.uint64).astype(np.uint32)
    fc = tforcol.pack_for(vals, device="cpu")
    sfc = tforcol.ForColumn(base=fc.base, dev=tdist.shard_column(fc.dev, tmesh))
    bits, count = tq.evaluate_sharded(tforcol.normalize(tq.Range(sfc, 40_050, 40_300)), tmesh)
    expect = (vals >= 40_050) & (vals < 40_300)
    assert int(count) == int(expect.sum())
    ubits, ucount = tforcol.evaluate(tq.Range(fc, 40_050, 40_300))
    jbits, jcount = jq.evaluate(jforcol.normalize(jq.Range(jforcol.pack_for(vals), 40_050,
                                                           40_300)), interpret=True)
    words = tscan.bits_to_canonical(tdist.fetch_global(bits, tmesh), n)
    assert bool((words == ubits).all()) and int(count) == int(ucount) == int(jcount)
    np.testing.assert_array_equal(_u32(words), np.asarray(jbits))


def test_multiproc_demo_two_gloo_processes():
    """The sharded surface across real process boundaries: two processes of
    two CPU shards each, joined in one gloo group."""
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(root)
    out = subprocess.run(
        [sys.executable, "-m", "shared_simd_scan_tpu_torch.parallel.multiproc_demo", "--nproc=2",
         "--devs-per-proc=2"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "multiproc demo: OK" in out.stdout
    assert out.stdout.count("all sharded paths verified") == 2
