"""The port's bit-sliced rows (runtime keys, and host keys), the AND-DAG
counters the member and aggregate tiers price with, and the route's
runtime-lookup table, against the JAX package.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same inputs from a numpy seed and must agree bit for bit (integer
words and counts, tolerance 0).  Each interpret-mode call compiles per key
set, so there are few of them.  The CUDA kernels are held against the
plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import oracle as joracle
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import scan as tscan
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

PLANNER_WIDTHS = (1, 3, 9, 16, 31)
SPREAD8 = [3, 70, 141, 200, 262, 333, 400, 511]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _keys_t(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32).copy())


def _columns(width, n, seed):
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n, dtype=np.uint64)
    values = values.astype(np.uint32)
    return values, jlayout.pack_device(values, width), tlayout.pack_device(values, width, device="cpu")


def _assert_same(tout, jout):
    tbits, tcounts = tout
    jbits, jcounts = jout
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))


# ---------------------------------------------------------------------------
# the AND-DAG's counters
# ---------------------------------------------------------------------------


def test_static_chunking_matches_jax():
    # the counted ops of one chunk's AND-DAG, which the member and
    # aggregate tiers price with
    rng = np.random.default_rng(9)
    for width in PLANNER_WIDTHS:
        for k in (1, 8, 32, 48):
            keys = rng.integers(0, 1 << width, size=k).tolist()
            assert tscan._static_dag_ops(width, keys) == jscan._static_dag_ops(width, keys)


@pytest.mark.parametrize("nplanes", [1, 3, 9, 16, 31, 32])
def test_transpose_bitplanes_plain_matches_jax(nplanes):
    rng = np.random.default_rng(nplanes)
    vs = rng.integers(0, 1 << 32, size=(32, 8, 16), dtype=np.uint64).astype(np.uint32)
    want = jscan._transpose_bitplanes([jnp.asarray(v) for v in vs], nplanes)
    got = tscan._transpose_bitplanes_plain([torch.from_numpy(v.astype(np.int64)) for v in vs],
                                           nplanes)
    assert len(got) == len(want) == nplanes
    for p in range(nplanes):
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want[p]).astype(np.int64))
        # plane p, bit r = bit p of value r
        expect = sum((((vs[r].astype(np.int64) >> p) & 1) << r) for r in range(32))
        np.testing.assert_array_equal(got[p].numpy(), expect)
    assert tscan._transpose_stages() == jscan._transpose_stages()


# ---------------------------------------------------------------------------
# runtime-key tier
# ---------------------------------------------------------------------------

RUNTIME_CASES = [
    # width, n, keys, block_offset
    (9, 4241, SPREAD8 + [70, 512, 1 << 31, 0xFFFFFFFF], 0),  # duplicate, out of domain
    (17, 4241, "random20", 100),                             # a shard holding the column's end
    (3, 4241, "random300", 0),                               # several 32-key chunks
    (31, 4241, "dup12", 0),                                  # duplicates, out of domain
]


def _named_keys(keys, width, values, rng):
    if keys == "random20":
        return [int(v) for v in values[rng.integers(0, values.shape[0], size=20)]]
    if keys == "random300":
        return rng.integers(0, 2 << width, size=300).tolist()
    if keys == "dup12":
        drawn = [int(v) for v in values[rng.integers(0, values.shape[0], size=8)]]
        return drawn + [drawn[0], drawn[5], 1 << 31, 0xFFFFFFFF]
    return keys


@pytest.mark.parametrize("width,n,keys,offset", RUNTIME_CASES)
def test_bitsliced_tiles_matches_jax(width, n, keys, offset):
    values, jdev, tdev = _columns(width, n, seed=width + n)
    keys = _named_keys(keys, width, values, np.random.default_rng(width))
    jout = jscan.shared_scan_bitsliced_tiles(jdev.tiles, jnp.asarray(keys, jnp.uint32), width, n,
                                             interpret=True, block_offset=offset)
    tout = tscan.shared_scan_bitsliced_tiles(tdev.tiles, _keys_t(keys), width, n, offset)
    _assert_same(tout, jout)
    if offset == 0:
        assert tout[1].tolist() == [int(np.sum(values == np.uint32(key))) for key in keys]


# ---------------------------------------------------------------------------
# static AND-DAG tier
# ---------------------------------------------------------------------------

STATIC_CASES = [
    # width, n, keys, block_offset
    (9, 4241, SPREAD8, 8 * 128 - 100),
    (9, 30_000, "random33", 0),             # one chunk rounded up to 40 rows
    (17, 4241, "random40", 0),              # one 40-row chunk
    (9, 4241, "random64", 0),               # two 32-row chunks
    (1, 4241, [0, 1, 1, 2, 0], 0),          # width 1: planes and their complements only
    (31, 4241, "random32", 0),              # the widest DAG
]


@pytest.mark.parametrize("width,n,keys,offset", STATIC_CASES)
def test_bitsliced_static_tiles_matches_jax(width, n, keys, offset):
    values, jdev, tdev = _columns(width, n, seed=width * 3 + n)
    if isinstance(keys, str):
        k = int(keys[len("random"):])
        rng = np.random.default_rng(k)
        keys = [int(v) for v in values[rng.integers(0, n, size=k)]]
        keys[1] = 1 << width  # out of domain: a zero row
        keys[2] = keys[0]     # duplicate
    jout = jscan.shared_scan_bitsliced_static_tiles(jdev.tiles, keys, width, n, interpret=True,
                                                    block_offset=offset)
    tout = tscan.shared_scan_bitsliced_static_tiles(tdev.tiles, keys, width, n, offset)
    _assert_same(tout, jout)


def test_bitsliced_static_300_keys_matches_jax_oracle():
    # past the JAX package's 256-key call groups; held against its gather
    # oracle, which costs no interpret-mode compile per key set
    width, n = 11, 4241
    values = np.random.default_rng(300).integers(0, 1 << width, size=n).astype(np.uint32)
    keys = np.random.default_rng(301).integers(0, 1 << (width + 1), size=300).astype(np.uint32)
    tdev = tlayout.pack_device(values, width, device="cpu")
    bits, counts = tscan.shared_scan_bitsliced_static_tiles(tdev.tiles, keys, width, n)
    obits, ocounts = joracle.shared_scan(jlayout.pack(values, width), keys)
    np.testing.assert_array_equal(_u32(tscan.bits_to_canonical(bits, n)), np.asarray(obits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ocounts))


@pytest.mark.parametrize("k", [8, 64, 300, 1030])
@pytest.mark.parametrize("width", [1, 9, 16, 17, 20, 31])
def test_static_fold_matches_jax_oracle(width, k):
    # the fold's rows in caller order: duplicates (one across the launch
    # boundary at 1024 keys), keys past the domain and 0xFFFFFFFF give
    # their own rows; held against the JAX package's gather oracle
    n = 4241
    values = np.random.default_rng(width).integers(0, 1 << width, size=n).astype(np.uint32)
    rng = np.random.default_rng(k + width)
    keys = rng.integers(0, 2 << width, size=k).astype(np.uint32)
    keys[:4] = [values[0], values[0], 0xFFFFFFFF, 1 << width]
    if k > tscan.MAX_LAUNCH_KEYS:
        keys[tscan.MAX_LAUNCH_KEYS] = keys[5]
    tdev = tlayout.pack_device(values, width, device="cpu")
    bits, counts = tscan.shared_scan_bitsliced_static_tiles(tdev.tiles, keys, width, n)
    obits, ocounts = joracle.shared_scan(jlayout.pack(values, width), keys)
    np.testing.assert_array_equal(_u32(tscan.bits_to_canonical(bits, n)), np.asarray(obits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ocounts))


def test_static_and_windowed_tiers_refuse_no_keys():
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32)
    for fn in (tscan.shared_scan_bitsliced_static_tiles, tscan.windowed_scan_tiles):
        with pytest.raises(ValueError, match="at least one key"):
            fn(tiles, [], 9, 100)
    with pytest.raises(ValueError):
        tscan.shared_scan_bitsliced_tiles(tiles, torch.zeros((0,), dtype=torch.int32), 9, 100)
    with pytest.raises(TypeError):
        tscan.shared_scan_bitsliced_tiles(tiles, torch.zeros(2, dtype=torch.int64), 9, 100)


def test_runtime_lookup_rule_takes_only_measured_wins():
    # the lookup at a k the sweep timed only where it won there, between two
    # timed k only where it won at both, never below 128 keys or at widths
    # where it never won
    timed = tscan._RUNTIME_SWEEP_KS
    for width in range(1, 32):
        wins = tscan._RUNTIME_LOOKUP_KS.get(width, ())
        assert set(wins) <= set(timed)
        for k in range(1, tscan.MAX_LAUNCH_KEYS + 1):
            lo = max((m for m in timed if m <= k), default=None)
            hi = min(m for m in timed if m >= k)
            assert tscan._runtime_lookup_wins(width, k) == (lo in wins and hi in wins), (width, k)
            if k < 128 or width <= 9 or 13 <= width <= 19:
                assert not tscan._runtime_lookup_wins(width, k), (width, k)


def test_cpu_wrappers_launch_nothing():
    _, _, tdev = _columns(9, 1000, seed=2)
    fns = (tscan.shared_scan_bitsliced_tiles, tscan.shared_scan_bitsliced_static_tiles,
           tscan.windowed_scan_tiles)
    before = [profiling.launch_count(f) for f in fns]
    tscan.shared_scan_bitsliced_tiles(tdev.tiles, _keys_t(SPREAD8), 9, 1000)
    tscan.shared_scan_bitsliced_static_tiles(tdev.tiles, SPREAD8, 9, 1000)
    tscan.windowed_scan_tiles(tdev.tiles, SPREAD8, 9, 1000)
    assert [profiling.launch_count(f) for f in fns] == before
