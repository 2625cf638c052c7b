"""The port's bit-sliced tiers (runtime keys, and host keys through the
static AND-DAG) and their planners against the JAX package.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same inputs from a numpy seed and must agree bit for bit (integer
words and counts, tolerance 0).  The planners are pure Python and must make
the same decision on every key set of the sweep.  Each interpret-mode call
compiles per key set, so there are few of them.  The CUDA kernels are held
against the plain versions in test_torch_cuda.py.
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


def key_sets(width: int, k: int, rng) -> dict[str, np.ndarray]:
    """Key sets of size k: spread, clustered, reversed run, gapped run,
    duplicates, and a third out of domain (>= 2^width)."""
    dom = 1 << width
    lo = int(rng.integers(0, dom))
    sets = {
        "spread": rng.integers(0, dom, size=k),
        "clustered": (lo + rng.integers(0, 48, size=k)) % dom,
        "reversed": (lo + np.arange(k)[::-1]) % dom,
        "gapped": (lo + 2 * np.arange(k)) % dom,
        "duplicate": np.repeat(rng.integers(0, dom, size=(k + 1) // 2), 2)[:k],
        "out_of_domain": np.where(rng.random(k) < 0.3, dom + rng.integers(0, 1 << 20, size=k),
                                  rng.integers(0, dom, size=k)) % (1 << 32),
    }
    return {name: keys.astype(np.uint32) for name, keys in sets.items()}


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", PLANNER_WIDTHS)
def test_pick_concrete_tier_matches_jax(width):
    rng = np.random.default_rng(width)
    tiers = set()
    for k in [*range(1, 65), *range(65, 301, 3)]:
        for kind, keys in key_sets(width, k, rng).items():
            got = tscan.pick_concrete_tier(width, keys)
            assert got == jscan.pick_concrete_tier(width, keys), (k, kind)
            assert tscan.bitsliced_static_cost(width, keys) == jscan.bitsliced_static_cost(width, keys)
            tiers.add(got[0])
    assert "bitsliced_static" in tiers or width == 1
    # the planner also takes a CPU tensor of keys
    keys = key_sets(width, 40, rng)["spread"]
    assert tscan.pick_concrete_tier(width, torch.from_numpy(keys.view(np.int32))) \
        == jscan.pick_concrete_tier(width, keys)


def test_reference_key_sets_take_the_expected_tiers():
    rng = np.random.default_rng(3)
    s64 = sorted(rng.choice(512, 64, replace=False).tolist())
    s256 = rng.choice(512, 256, replace=False).tolist()
    for keys, tier in ((SPREAD8, "bitsliced_static"), (s64, "bitsliced_static"),
                       (s256, "bitsliced_static"), ([0, 2, 4, 6], "windowed"),
                       ([0, 1, 2, 4, 5, 6, 7], "windowed"), (list(range(7, -1, -1)), "windowed"),
                       ([3], "compare"), ([1, 300], "compare"), (list(range(8)), "interval")):
        assert tscan.pick_concrete_tier(9, keys)[0] == tier
        assert tscan.pick_concrete_tier(9, keys) == jscan.pick_concrete_tier(9, keys)
    assert tscan.bitsliced_static_cost(9, SPREAD8) == 47


def test_bitsliced_wins_matches_jax():
    for width in range(1, 32):
        for k in range(0, 400):
            assert tscan.bitsliced_cost(width, k) == jscan.bitsliced_cost(width, k)
            assert tscan._bitsliced_wins(width, k) == jscan._bitsliced_wins(width, k)
    assert [k for k in range(1, 10) if tscan._bitsliced_wins(9, k)][0] == 5


def test_static_chunking_matches_jax():
    for k in range(0, 2100):
        assert tscan._static_group_sizes(k) == jscan._static_group_sizes(k)
        if k:
            assert tscan._static_krows(k) == jscan._static_krows(k)
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
]


def _named_keys(keys, width, values, rng):
    if keys == "random20":
        return [int(v) for v in values[rng.integers(0, values.shape[0], size=20)]]
    if keys == "random300":
        return rng.integers(0, 2 << width, size=300).tolist()
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


def _run_program(planes, prog, k):
    """What sss_bitsliced_static_scan does with a program, in torch."""
    slots = {}
    for p, plane in enumerate(planes):
        slots[p] = plane
    rows = [None] * k

    def operand(o):
        v = slots[o & 0x7FFF]
        return (~v & 0xFFFFFFFF) if o & 0x8000 else v

    for w0, w1 in prog.view(np.uint32).tolist():
        kind, target = w0 >> 30, w0 & 0x3FFFFFFF
        if kind == tscan._AND:
            slots[target] = operand(w1 & 0xFFFF) & operand(w1 >> 16)
        elif kind == tscan._OUT:
            rows[target] = operand(w1 & 0xFFFF)
        else:
            rows[target] = torch.zeros_like(planes[0])
    return rows


@pytest.mark.parametrize("width", [1, 9, 31])
def test_static_program_computes_the_plain_rows(width):
    # the host-compiled program, run as the kernel runs it, with its slots
    # reused after each node's last use, gives the plain version's words
    n = 4241
    values, _, tdev = _columns(width, n, seed=width + 77)
    rng = np.random.default_rng(width)
    keys = rng.integers(0, min(2 << width, 5000), size=1100).tolist()
    keys[:3] = [int(values[0]), int(values[0]), 1 << width]
    planes = tscan._bitplanes_plain(tdev.tiles, width)
    valid = tscan._valid_words(tdev.tiles.shape[1], n, 0, "cpu")
    rows = []
    for g0 in range(0, len(keys), tscan.MAX_LAUNCH_KEYS):
        group = tuple(keys[g0 : g0 + tscan.MAX_LAUNCH_KEYS])
        prog, slots = tscan._static_program(width, group)
        words = prog.view(np.uint32)
        assert (words[words[:, 0] >> 30 == tscan._AND, 0] & 0x3FFFFFFF).max(initial=0) < slots
        rows += _run_program(planes, prog, len(group))
    got = tscan._finish(torch.stack(rows), valid)
    want = tscan.shared_scan_bitsliced_static_tiles_plain(tdev.tiles, keys, width, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_static_program_slots_follow_liveness():
    keys = tuple(np.random.default_rng(1).integers(0, 1 << 31, size=32).tolist())
    _, slots = tscan._static_program(31, keys)
    # width planes plus the DAG's peak liveness, which the JAX package
    # measures at about 134 values with complements counted; more than
    # 48 KB at 128 threads, within the shared memory of a CTA
    assert 31 < slots <= jscan._static_dag_liveness(31, list(keys))
    assert slots * 128 * 4 > 48 * 1024
    assert tscan._static_threads(slots) == 128
    assert tscan._static_program(9, tuple(SPREAD8))[1] < 32
    with pytest.raises(ValueError):
        tscan._static_threads(2000)


def test_static_and_windowed_tiers_refuse_no_keys():
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32)
    for fn in (tscan.shared_scan_bitsliced_static_tiles, tscan.windowed_scan_tiles):
        with pytest.raises(ValueError, match="at least one key"):
            fn(tiles, [], 9, 100)
    with pytest.raises(ValueError):
        tscan.shared_scan_bitsliced_tiles(tiles, torch.zeros((0,), dtype=torch.int32), 9, 100)
    with pytest.raises(TypeError):
        tscan.shared_scan_bitsliced_tiles(tiles, torch.zeros(2, dtype=torch.int64), 9, 100)


def test_cpu_wrappers_launch_nothing():
    _, _, tdev = _columns(9, 1000, seed=2)
    fns = (tscan.shared_scan_bitsliced_tiles, tscan.shared_scan_bitsliced_static_tiles,
           tscan.windowed_scan_tiles)
    before = [f.launches for f in fns]
    tscan.shared_scan_bitsliced_tiles(tdev.tiles, _keys_t(SPREAD8), 9, 1000)
    tscan.shared_scan_bitsliced_static_tiles(tdev.tiles, SPREAD8, 9, 1000)
    tscan.windowed_scan_tiles(tdev.tiles, SPREAD8, 9, 1000)
    assert [f.launches for f in fns] == before
