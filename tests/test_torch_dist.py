"""The port's data-parallel layer (``parallel.dist``) against the JAX
package's on the virtual 8-device CPU mesh, and against its own unsharded
results.

The JAX mesh is ``dist.make_mesh()`` over the 8 forced CPU devices
(tests/conftest.py), its kernels in interpret mode; the port's mesh is
``make_mesh(["cpu"] * 8)``, eight shards on the CPU, its wrappers' plain
versions.  The columns come from one numpy seed; the port's cross from
the JAX package's with ``layout.from_jax_numpy``.  Every comparison is
exact integer equality.  n = 70,003 puts the ragged end inside shard 2 of
8 (B1 padded from 24 to 64, 8 a shard); shards 3-7 hold padding only.
Each interpret-mode call compiles per shape and key count, so the forms
with no JAX mesh test of their own are held against the JAX single-device
function at few keys.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import aggregate as jagg
from shared_simd_scan_tpu.ops import conj as jconj
from shared_simd_scan_tpu.ops import member as jmember
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu.ops import unpack as junpack
from shared_simd_scan_tpu.parallel import dist as jdist
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.bench import scaling as tscaling
from shared_simd_scan_tpu_torch.ops import aggregate as tagg
from shared_simd_scan_tpu_torch.ops import conj as tconj
from shared_simd_scan_tpu_torch.ops import member as tmember
from shared_simd_scan_tpu_torch.ops import scan as tscan
from shared_simd_scan_tpu_torch.ops import unpack as tunpack
from shared_simd_scan_tpu_torch.parallel import dist as tdist

torch.set_num_threads(1)

N = 70_003
WIDTH = 9
SPREAD = (np.arange(8, dtype=np.uint32) * 97 + 5) % (1 << WIDTH)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _column(width: int, n: int, seed: int):
    """(values, JAX DeviceColumn, port DeviceColumn) of one seeded column."""
    vals = np.random.default_rng(seed).integers(0, 1 << width, n, dtype=np.uint64)
    vals = vals.astype(np.uint32)
    jdev = jlayout.to_device(jlayout.pack(vals, width))
    return vals, jdev, tlayout.from_jax_numpy(width, n, np.asarray(jdev.tiles), "cpu")


@pytest.fixture(scope="module")
def meshes():
    return jdist.make_mesh(), tdist.make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def col(meshes):
    """The 9-bit column: values, the JAX and port columns, and both
    sharded."""
    jmesh, tmesh = meshes
    vals, jdev, tdev = _column(WIDTH, N, 0)
    return vals, jdev, tdev, jdist.shard_column(jdev, jmesh), tdist.shard_column(tdev, tmesh)


@pytest.fixture(scope="module")
def measure(meshes):
    """A 16-bit measure column of the same n: values, JAX and port
    columns, the port's sharded."""
    vals, jdev, tdev = _column(16, N, 1)
    return vals, jdev, tdev, tdist.shard_column(tdev, meshes[1])


def test_mesh_of_eight_cpu_shards(meshes):
    jmesh, tmesh = meshes
    assert tmesh.size == jmesh.devices.size == 8
    assert (tmesh.rank, tmesh.world_size, tmesh.group) == (0, 1, None)
    assert [tmesh.shard_index(i) for i in range(8)] == list(range(8))
    if not torch.cuda.is_available():  # no quiet CPU mesh
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.make_mesh()


@pytest.mark.parametrize("n", [N, 8 * 8 * 128 * 32])
def test_shard_column_matches_the_jax_sharded_tiles(meshes, n):
    jmesh, tmesh = meshes
    _, jdev, tdev = _column(WIDTH, n, 2)
    jsd, tsd = jdist.shard_column(jdev, jmesh), tdist.shard_column(tdev, tmesh)
    assert tsd.b1 == jsd.tiles.shape[1] and tsd.local_b1 * 8 == tsd.b1
    for i, shard in enumerate(tsd.shards):
        assert shard.is_contiguous() and tuple(shard.shape) == (WIDTH, tsd.local_b1, 128)
        assert tsd.block_offset(i) == i * tsd.local_b1 * 128
    np.testing.assert_array_equal(_u32(tdist.fetch_global(tsd.shards, tmesh)),
                                  np.asarray(jsd.tiles))


@pytest.mark.parametrize("keys,tier", [(np.arange(4, dtype=np.uint32), "interval"),
                                       (SPREAD, "bitsliced_static")])
def test_sharded_shared_scan_matches_the_jax_mesh(meshes, col, keys, tier):
    jmesh, tmesh = meshes
    vals, jdev, tdev, jsd, tsd = col
    assert tscan.pick_concrete_tier(WIDTH, keys)[0] == tier
    jbits, jcounts = jdist.sharded_shared_scan(jsd, keys, jmesh, interpret=True)
    tbits, tcounts = tdist.sharded_shared_scan(tsd, keys, tmesh)
    assert len(tbits) == 8 and all(tuple(b.shape) == (len(keys), 8, 128) for b in tbits)
    np.testing.assert_array_equal(_u32(tdist.fetch_global(tbits, tmesh)), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.tolist() == [int((vals == k).sum()) for k in keys]
    ubits, ucounts = tscan.shared_scan_device(tdev, keys)
    assert bool((tscan.bits_to_canonical(tdist.fetch_global(tbits, tmesh), N) == ubits).all())
    assert bool((tcounts == ucounts).all())


def test_sharded_histogram_matches_the_jax_mesh(meshes, col):
    jmesh, tmesh = meshes
    vals, _, _, jsd, tsd = col
    jsub = jdist.sharded_histogram(jsd, jmesh, lo=20, k=16, interpret=True)
    tsub = tdist.sharded_histogram(tsd, tmesh, lo=20, k=16)
    np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub))
    expect = np.bincount(vals, minlength=1 << WIDTH)
    np.testing.assert_array_equal(tdist.sharded_histogram(tsd, tmesh).numpy(), expect)
    # a tensor lo takes the runtime-lo kernel's plain version on every shard
    lo = torch.tensor([500], dtype=torch.int32)
    np.testing.assert_array_equal(tdist.sharded_histogram(tsd, tmesh, lo=lo, k=12).numpy(),
                                  expect[500:512])


def test_sharded_scan_unpack_and_interval(meshes, col):
    _, tmesh = meshes
    vals, jdev, tdev, jsd, tsd = col
    key = int(vals[11])
    bits, count = tdist.sharded_scan(tsd, key, tmesh)
    assert int(count) == int((vals == key).sum())
    ubits, _ = tscan.scan_device(tdev, key)
    assert bool((tscan.bits_to_canonical(tdist.fetch_global(bits, tmesh), N) == ubits).all())
    out = tdist.sharded_unpack(tsd, tmesh)
    values = tunpack.values_to_flat(tdist.fetch_global(out, tmesh), N)
    np.testing.assert_array_equal(_u32(values), vals)
    jvals = junpack.values_to_flat(junpack.unpack_tiles(jdev.tiles, WIDTH, interpret=True), N)
    np.testing.assert_array_equal(_u32(values), np.asarray(jvals))
    ibits, icounts = tdist.sharded_interval_scan(tsd, 100, 8, tmesh)
    ubits, ucounts = tscan.interval_scan_device(tdev, 100, 8)
    assert bool((tscan.bits_to_canonical(tdist.fetch_global(ibits, tmesh), N) == ubits).all())
    assert bool((icounts == ucounts).all())


def test_sharded_range_scan(meshes, col):
    _, tmesh = meshes
    vals, jdev, tdev, jsd, tsd = col
    lows, highs = np.array([0, 100], np.uint32), np.array([50, 400], np.uint32)
    bits, counts = tdist.sharded_range_scan(tsd, lows, highs, tmesh)
    words = tscan.bits_to_canonical(tdist.fetch_global(bits, tmesh), N)
    ubits, ucounts = tscan.range_scan_device(tdev, lows, highs)
    jbits, jcounts = jscan.range_scan_device(jdev, lows, highs, interpret=True)
    assert bool((words == ubits).all()) and bool((counts == ucounts).all())
    np.testing.assert_array_equal(_u32(words), np.asarray(jbits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_sharded_conj_range_scan(meshes, col, measure):
    _, tmesh = meshes
    vals, jdev, tdev, jsd, tsd = col
    mvals, jm, tm, tsm = measure
    lows, highs = np.array([100, 2000], np.uint32), np.array([400, 30000], np.uint32)
    bits, count = tdist.sharded_conj_range_scan([tsd, tsm], lows, highs, tmesh)
    words = tscan.bits_to_canonical(tdist.fetch_global(bits, tmesh), N)
    ubits, ucount = tconj.conj_range_scan_device([tdev, tm], lows, highs)
    jbits, jcount = jconj.conj_range_scan_device([jdev, jm], lows, highs, interpret=True)
    assert bool((words == ubits).all()) and int(count) == int(ucount) == int(jcount)
    np.testing.assert_array_equal(_u32(words), np.asarray(jbits))
    assert int(count) == int(((vals >= 100) & (vals < 400) & (mvals >= 2000)
                              & (mvals < 30000)).sum())


def test_sharded_member_scan(meshes, col):
    _, tmesh = meshes
    vals, jdev, tdev, jsd, tsd = col
    for keys in ([5, 300], SPREAD, list(range(40, 72))):
        bits, count = tdist.sharded_member_scan(tsd, keys, tmesh)
        words = tscan.bits_to_canonical(tdist.fetch_global(bits, tmesh), N)
        ubits, ucount = tmember.member_scan_device(tdev, keys)
        assert bool((words == ubits).all()) and int(count) == int(ucount)
        assert int(count) == int(np.isin(vals, keys).sum())
    jbits, jcount = jmember.member_scan_device(jdev, np.array([5, 300], np.uint32),
                                               interpret=True)
    bits, count = tdist.sharded_member_scan(tsd, [5, 300], tmesh)
    np.testing.assert_array_equal(
        _u32(tscan.bits_to_canonical(tdist.fetch_global(bits, tmesh), N)), np.asarray(jbits))
    assert int(count) == int(jcount)


def test_sharded_aggregate_and_minmax(meshes, col, measure):
    _, tmesh = meshes
    vals, jdev, tdev, jsd, tsd = col
    mvals, jm, tm, tsm = measure
    keys = np.array([3, 70], np.uint32)
    jsums, jcounts = jagg.aggregate_scan_device(jdev, jm, keys, interpret=True)
    jmins, jmaxs, jmcounts = jagg.minmax_scan_device(jdev, jm, keys, interpret=True)
    for ks in (keys, np.arange(32, dtype=np.uint32)):
        sums, counts = tdist.sharded_aggregate_scan(tsd, tsm, ks, tmesh)
        usums, ucounts = tagg.aggregate_scan_device(tdev, tm, ks)
        assert sums.dtype == np.uint64
        np.testing.assert_array_equal(sums, usums.numpy().astype(np.uint64))
        assert bool((counts == ucounts).all())
        mins, maxs, mcounts = tdist.sharded_minmax_scan(tsd, tsm, ks, tmesh)
        umins, umaxs, umcounts = tagg.minmax_scan_device(tdev, tm, ks)
        assert all(bool((a == b).all()) for a, b in ((mins, umins), (maxs, umaxs),
                                                     (mcounts, umcounts)))
    sums, counts = tdist.sharded_aggregate_scan(tsd, tsm, keys, tmesh)
    mins, maxs, mcounts = tdist.sharded_minmax_scan(tsd, tsm, keys, tmesh)
    np.testing.assert_array_equal(sums, np.asarray(jsums))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(mins.numpy(), np.asarray(jmins))
    np.testing.assert_array_equal(maxs.numpy(), np.asarray(jmaxs))
    np.testing.assert_array_equal(mcounts.numpy(), np.asarray(jmcounts))
    # a key with no row: the empty-group sentinels survive the MIN/MAX reduction
    mins, maxs, mcounts = tdist.sharded_minmax_scan(tsd, tsm, [511, 600], tmesh)
    assert mins.tolist()[1] == 1 << 16 and maxs.tolist()[1] == 0 and mcounts.tolist()[1] == 0


LINEAR_KEYS = np.array([3, 70, 141, 511], np.uint32)


@pytest.mark.parametrize("form", ["interval", "static", "traced"])
def test_sharded_linear_exports(meshes, col, form):
    _, tmesh = meshes
    vals, jdev, tdev, jsd, tsd = col
    k = 4
    if form == "interval":
        out, counts = tdist.sharded_linear_scan(tsd, 200, k, tmesh)
        uout, ucounts = tscan.interval_scan_linear_words_tiles(tdev.tiles, 200, k, WIDTH, N)
        jout, jcounts = jscan.interval_scan_linear_words_tiles(jdev.tiles, 200, k, WIDTH, N,
                                                               interpret=True)
    elif form == "static":
        out, counts = tdist.sharded_static_linear_scan(tsd, LINEAR_KEYS, tmesh)
        uout, ucounts = tscan.static_scan_linear_words_tiles(tdev.tiles, LINEAR_KEYS, WIDTH, N)
        jout, jcounts = jscan.static_scan_linear_words_tiles(jdev.tiles, LINEAR_KEYS, WIDTH, N,
                                                             interpret=True)
    else:
        out, counts = tdist.sharded_traced_linear_scan(tsd, LINEAR_KEYS, tmesh)
        uout, ucounts = tscan.bitsliced_scan_linear_words_tiles(tdev.tiles, LINEAR_KEYS, WIDTH,
                                                                N)
        jout, jcounts = jscan.bitsliced_scan_linear_words_tiles(
            jdev.tiles, jnp.asarray(LINEAR_KEYS), WIDTH, N, interpret=True)
    # each shard holds its block of the JAX P(DATA_AXIS, None) output,
    # the last one included: a span of the global stream
    assert all(tuple(o.shape) == (tsd.local_b1, 128 * k) for o in out)
    nwords = (N + 7) // 8 * k // 4
    words = tdist.fetch_global(out, tmesh).reshape(-1)[:nwords]
    assert bool((words == uout).all()) and bool((counts == ucounts).all())
    np.testing.assert_array_equal(_u32(words), np.asarray(jout))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_sharded_calls_refuse_other_columns(meshes, col):
    _, tmesh = meshes
    _, _, tdev, _, tsd = col
    with pytest.raises(TypeError, match="ShardedColumn"):
        tdist.sharded_shared_scan(tdev, [1], tmesh)
    other = tdist.make_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="another mesh"):
        tdist.sharded_shared_scan(tsd, [1], other)


def test_scaling_bench_on_cpu_shards(capsys):
    results = tscaling.bench_scaling(16 * 1024, 2, 8, WIDTH, devices=["cpu"] * 2)
    assert [nd for nd, _, _ in results] == [1, 2]
    out = capsys.readouterr().out
    assert out.count("* sharded shared scan k=8 on ") == 2
    assert "verification: ok" in out
