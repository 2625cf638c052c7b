"""The port's windowed tier, its planners, and the full dispatcher against
the JAX package.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same inputs from a numpy seed and must agree bit for bit (integer
words and counts, tolerance 0).  Each interpret-mode call compiles per key
set, so there are few of them.  The CUDA kernel is held against the plain
version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _columns(width, n, seed):
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n, dtype=np.uint64)
    values = values.astype(np.uint32)
    return values, jlayout.pack_device(values, width), tlayout.pack_device(values, width, device="cpu")


def _assert_same(tout, jout):
    tbits, tcounts = tout
    jbits, jcounts = jout
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))


def _sweep_sets(rng):
    for width in (1, 3, 9, 16, 31):
        dom = 1 << width
        for k in range(1, 301, 7):
            lo = int(rng.integers(0, dom))
            yield (lo + rng.integers(0, 40, size=k)) % dom                     # clustered
            yield rng.integers(0, dom, size=k)                                   # spread
            yield (lo + np.arange(k)[::-1]) % dom                                # reversed
            yield np.where(rng.random(k) < 0.3, dom + rng.integers(0, 99, size=k),
                           np.repeat(rng.integers(0, dom, size=k), 1))           # out of domain
            yield np.repeat(rng.integers(0, dom, size=(k + 1) // 2), 2)[:k]      # duplicates


def test_window_planners_match_jax():
    rng = np.random.default_rng(0)
    for keys in _sweep_sets(rng):
        keys = keys.astype(np.uint32)
        assert tscan._window_plan(keys) == jscan._window_plan(keys)
        assert tscan._window_chunks(keys) == jscan._window_chunks(keys)
        assert tscan.windowed_cost(keys) == jscan.windowed_cost(keys)


def _walk_plan(vals, stream, k):
    """What sss_windowed_scan does with a plan stream, in torch."""
    s = stream.view(np.uint32).tolist()
    rows = [None] * k
    p = 1
    for _ in range(s[0]):
        base, nsub = s[p], s[p + 1]
        p += 2
        masks = [tscan._onehot_plain(v, base) for v in vals]
        for _ in range(nsub):
            byte, nent = s[p], s[p + 1]
            p += 2
            y = tscan._byte_rows(masks, byte)
            for _ in range(nent):
                rows[s[p + 1]] = y[s[p]]
                p += 2
    assert p == len(s)
    return rows


@pytest.mark.parametrize("width,k", [(9, 4), (9, 48), (9, 49), (3, 300), (17, 2100)])
def test_plan_stream_computes_the_plain_rows(width, k):
    # the single plan (k <= 48) and the chunked plan (k > 48, 1024 rows per
    # launch), walked as the kernel walks them, give the plain version's words
    n = 4241
    values, _, tdev = _columns(width, n, seed=k)
    rng = np.random.default_rng(k)
    keys = ((int(values[0]) + rng.integers(0, 150, size=k)) % (2 << width)).tolist()
    vals = tscan._block_values_plain(tdev.tiles, width)
    launches = tscan._window_launches(tuple(keys))
    assert len(launches) == -(-k // tscan.MAX_LAUNCH_KEYS)
    rows = []
    for r0, nrows, stream in launches:
        assert r0 == len(rows) and nrows <= tscan.MAX_LAUNCH_KEYS
        rows += _walk_plan(vals, stream, nrows)
    valid = tscan._valid_words(tdev.tiles.shape[1], n, 0, "cpu")
    got = tscan._finish(torch.stack(rows), valid)
    want = tscan.windowed_scan_tiles_plain(tdev.tiles, keys, width, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


WINDOWED_CASES = [
    # width, n, keys, block_offset
    (9, 4241, [0, 2, 4, 6], 0),
    (9, 30_000, [7, 6, 5, 4, 3, 2, 1, 0], 8 * 128 * 3 - 200),  # reversed run, a shard's end
    (3, 4241, [1, 1, 5, 8, 9, 1 << 31, 0xFFFFFFFF], 0),       # duplicates, out of domain
    (17, 4241, "clustered20", 0),
    (9, 4241, "clustered64", 0),                                # k > 48: the chunked kernel
]


@pytest.mark.parametrize("width,n,keys,offset", WINDOWED_CASES)
def test_windowed_tiles_matches_jax(width, n, keys, offset):
    values, jdev, tdev = _columns(width, n, seed=width + n)
    if isinstance(keys, str):
        k = int(keys[len("clustered"):])
        rng = np.random.default_rng(k)
        keys = ((int(values[0]) + rng.integers(0, 70, size=k)) % (1 << width)).tolist()
        keys[-1] = 1 << width
    jout = jscan.windowed_scan_tiles(jdev.tiles, keys, width, n, interpret=True,
                                     block_offset=offset)
    tout = tscan.windowed_scan_tiles(tdev.tiles, keys, width, n, offset)
    _assert_same(tout, jout)
    if offset == 0:
        assert tout[1].tolist() == [int(np.sum(values == np.uint32(key))) for key in keys]


# ---------------------------------------------------------------------------
# the full dispatcher
# ---------------------------------------------------------------------------

DEVICE_SETS = [
    ("interval", list(range(100, 120))),
    ("windowed", [0, 1, 2, 4, 5, 6, 7, 7]),                                    # duplicate
    ("bitsliced_static", [3, 70, 141, 200, 262, 333, 400, 511, 70, 1 << 31]),  # out of domain
    ("compare", [5, 300, 0xFFFFFFFF]),
]


@pytest.mark.parametrize("tier,keys", DEVICE_SETS)
def test_shared_scan_device_matches_jax_for_every_tier(tier, keys):
    width, n = 9, 20_001
    values, jdev, tdev = _columns(width, n, seed=len(keys))
    arr = np.asarray(keys, np.uint32)
    assert tscan.pick_concrete_tier(width, arr) == jscan.pick_concrete_tier(width, arr)
    assert tscan.pick_concrete_tier(width, arr)[0] == tier
    jbits, jcounts = jscan.shared_scan_device(jdev, arr, interpret=True)
    for given in (keys, arr, torch.from_numpy(arr.view(np.int32))):  # every host form
        tbits, tcounts = tscan.shared_scan_device(tdev, given)
        np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.tolist() == [int(np.sum(values == key)) for key in arr]
