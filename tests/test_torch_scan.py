"""The port's compare scan, interval scan, shift canary and dispatcher
against the JAX package.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same inputs from a numpy seed and must agree bit for bit.  The
CUDA kernels are held against the plain versions in test_torch_cuda.py.
"""
import ctypes

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


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _keys_t(keys, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32).copy()).to(device)


def _columns(width, n, seed):
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n, dtype=np.uint64)
    values = values.astype(np.uint32)
    return values, jlayout.pack_device(values, width), tlayout.pack_device(values, width, device="cpu")


def _assert_same(tout, jout):
    tbits, tcounts = tout
    jbits, jcounts = jout
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.cpu().numpy(), np.asarray(jcounts).astype(np.int64))


# ---------------------------------------------------------------------------
# compare tier
# ---------------------------------------------------------------------------

COMPARE_CASES = [
    (9, 100, "zero"),            # key 0 over the zero padding of one partial lane tile
    (9, 4241, "out_of_domain"),  # 2^w, 2^31 and 0xFFFFFFFF match nothing
    (9, 32768, "spread"),
    (3, 4241, "spread"),
    (17, 4241, "out_of_domain"),
    (31, 4241, "spread"),
    (1, 4241, "zero"),
]


@pytest.mark.parametrize("width,n,kind", COMPARE_CASES)
def test_shared_scan_tiles_matches_jax(width, n, kind):
    values, jdev, tdev = _columns(width, n, seed=width * 7 + n)
    dom = 1 << width
    keys = {
        "zero": [0],
        "out_of_domain": [dom, 1 << 31, 0xFFFFFFFF, int(values[0])],
        "spread": [int(values[3]), int(values[9]), int(values[5]) ^ 1, dom - 1, 0],
    }[kind]
    jout = jscan.shared_scan_tiles(jdev.tiles, jnp.asarray(keys, jnp.uint32), width, n,
                                   interpret=True)
    tout = tscan.shared_scan_tiles(tdev.tiles, _keys_t(keys), width, n)
    _assert_same(tout, jout)
    for j, key in enumerate(keys):
        assert int(tout[1][j]) == int(np.sum(values == np.uint32(key)))


def test_shared_scan_tiles_block_offset_matches_jax():
    # a shard of a longer column: the tail mask comes from the global block id
    width, n = 9, 30_000
    values, jdev, tdev = _columns(width, n, seed=11)
    offset = 8 * 128 * 3 - 200  # places the column's end inside this shard
    keys = [0, int(values[1])]
    jout = jscan.shared_scan_tiles(jdev.tiles, jnp.asarray(keys, jnp.uint32), width, n,
                                   interpret=True, block_offset=offset)
    _assert_same(tscan.shared_scan_tiles(tdev.tiles, _keys_t(keys), width, n, block_offset=offset),
                 jout)


# ---------------------------------------------------------------------------
# interval tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 8, 20, 33, 64])
@pytest.mark.parametrize("lo_kind", ["zero", "top"])
def test_interval_scan_tiles_matches_jax(k, lo_kind):
    width, n = 9, 32_000
    _, jdev, tdev = _columns(width, n, seed=k)
    lo = 0 if lo_kind == "zero" else (1 << width) - 4
    jout = jscan.interval_scan_tiles(jdev.tiles, lo, k, width, n, interpret=True)
    _assert_same(tscan.interval_scan_tiles(tdev.tiles, lo, k, width, n), jout)


@pytest.mark.parametrize("width,lo,k", [(1, 0, 2), (5, 3, 8), (17, 70_000, 40), (31, (1 << 31) - 4, 8)])
def test_interval_scan_tiles_other_widths_match_jax(width, lo, k):
    n = 4241
    values, jdev, tdev = _columns(width, n, seed=width + 500)
    values[: 4 * k] = (lo + np.arange(4 * k)) % (1 << width)  # make sure keys hit
    jdev = jlayout.pack_device(values, width)
    tdev = tlayout.pack_device(values, width, device="cpu")
    jout = jscan.interval_scan_tiles(jdev.tiles, lo, k, width, n, interpret=True)
    tout = tscan.interval_scan_tiles(tdev.tiles, lo, k, width, n)
    _assert_same(tout, jout)
    assert int(tout[1].sum()) > 0


def test_interval_scan_1024_keys_matches_oracle():
    width, n = 11, 4241
    values, _, tdev = _columns(width, n, seed=1024)
    bits, counts = tscan.interval_scan_device(tdev, 0, 1024)
    obits, ocounts = joracle.shared_scan(jlayout.pack(values, width), np.arange(1024, dtype=np.uint32))
    np.testing.assert_array_equal(_u32(bits), np.asarray(obits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ocounts))


def test_interval_scan_block_offset_matches_jax():
    width, n = 9, 30_000
    _, jdev, tdev = _columns(width, n, seed=12)
    offset = 8 * 128 * 3 - 200
    jout = jscan.interval_scan_tiles(jdev.tiles, 0, 8, width, n, interpret=True,
                                     block_offset=offset)
    _assert_same(tscan.interval_scan_tiles(tdev.tiles, 0, 8, width, n, block_offset=offset), jout)


def test_interval_scan_rejects_bad_k():
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32)
    for k in (0, 1025):
        with pytest.raises(ValueError, match="1 <= k"):
            tscan.interval_scan_tiles(tiles, 0, k, 9, 100)
    with pytest.raises(ValueError):
        tscan.interval_scan_tiles(tiles, -1, 8, 9, 100)


def test_shared_scan_tiles_rejects_bad_keys():
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        tscan.shared_scan_tiles(tiles, torch.zeros(2, dtype=torch.int64), 9, 100)
    with pytest.raises(ValueError):
        tscan.shared_scan_tiles(tiles, torch.zeros((0,), dtype=torch.int32), 9, 100)
    with pytest.raises(ValueError):
        tscan.shared_scan_tiles(tiles, torch.zeros((2, 2), dtype=torch.int32), 9, 100)


# ---------------------------------------------------------------------------
# shift canary
# ---------------------------------------------------------------------------


def test_shift_canary_plain_saturates():
    base, amounts = tscan.canary_inputs("cpu")
    assert set(int(a) & 0xFFFFFFFF for a in amounts.flatten().tolist()) == set(tscan.CANARY_AMOUNTS)
    assert all(a >= 32 for a in tscan.CANARY_AMOUNTS)
    ptx, cxx = tscan.run_shift_canary(base, amounts)
    assert not ptx.any() and not cxx.any()
    assert tscan.shift_saturates("cpu")
    # below 32 the plain shift is the ordinary one
    small = torch.arange(32, dtype=torch.int32).reshape(1, 32)
    got = tscan.shift_canary_plain(torch.ones_like(small), small)
    assert _u32(got).tolist() == [[1 << d for d in range(32)]]


def test_shift_saturates_matches_jax_verdict():
    assert tscan.shift_saturates("cpu") == jscan.shift_saturates(interpret=True)


def test_shift_verdict_plain_matches_jax_verdict():
    before = profiling.launch_count(tscan.shift_verdict)
    assert tscan.shift_verdict("cpu") == tscan.shift_verdict_plain() == jscan.shift_saturates(
        interpret=True)
    # the plain version launches nothing
    assert profiling.launch_count(tscan.shift_verdict) == before


@pytest.mark.parametrize("ballot", [0, 0x10, 0xFFFF])
def test_shift_verdict_launch_arguments(ballot, monkeypatch):
    # the CUDA branch with the launch recorded: one launch, the 16 amounts
    # by value from a host array, the ballot word read back from the host
    calls = []

    def launch(fn, device, amounts, count, word):
        calls.append((fn, device, count))
        sent = np.frombuffer((ctypes.c_uint32 * count).from_address(amounts), np.uint32)
        assert sent.tolist() == list(tscan.CANARY_AMOUNTS)
        ctypes.c_uint32.from_address(word).value = ballot

    monkeypatch.setattr(tscan._cuda, "launch", launch)
    monkeypatch.setattr(tscan, "_SHIFT_SEMANTICS", {})
    before = profiling.launch_count(tscan.shift_verdict)
    assert tscan.shift_verdict("cuda:0") == (ballot == 0)
    assert tscan.shift_saturates("cuda:0") == (ballot == 0)
    assert calls == [("sss_shift_verdict", torch.device("cuda", 0), 16)] * 2
    assert profiling.launch_count(tscan.shift_verdict) == before + 2
    with pytest.raises(ValueError, match="only CUDA devices"):
        tscan.shift_verdict("meta")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_tier_matches_reference_for_consecutive_runs():
    for k in range(2, 1025):
        lo = (k * 37) % 512
        keys = np.arange(lo, lo + k, dtype=np.uint32)
        assert tscan.interval_or_keys(keys)[0] == jscan._consecutive_lo(keys) == lo
    for k in (1025, 2000):  # past the interval tier's limit
        keys = np.arange(k, dtype=np.uint32)
        assert tscan.interval_or_keys(keys)[0] is jscan._consecutive_lo(keys) is None


@pytest.mark.parametrize("keys", [[0, 2, 4], [1, 100, 300, 450], [5, 6, 7, 9, 200, 201]])
def test_sets_of_unported_tiers_fall_to_compare_with_same_bits(keys):
    # sets that are no consecutive run (the reference prices them to its
    # windowed and static AND-DAG tiers) take the route's kernel in the
    # port, with the same bits and counts, and so do the port's wrappers of
    # those two rows
    width, n = 9, 4241
    values, jdev, tdev = _columns(width, n, seed=len(keys))
    assert jscan._consecutive_lo(np.asarray(keys, np.uint32)) is None
    route = tscan.pick_route(width, len(keys))
    assert route == ("compare" if len(keys) < 4 else "fold")
    before = profiling.counters().get("tier." + route, 0)
    wrappers = (tscan.shared_scan_tiles, tscan.shared_scan_bitsliced_tiles)
    launched = [profiling.launch_count(fn) for fn in wrappers]
    jbits, jcounts = jscan.shared_scan_device(jdev, np.asarray(keys, np.uint32), interpret=True)
    tbits, tcounts = tscan.shared_scan_device(tdev, keys)
    assert profiling.counters()["tier." + route] == before + 1
    # CPU tensors take the plain version
    assert [profiling.launch_count(fn) for fn in wrappers] == launched
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    for fn in (tscan.windowed_scan_tiles, tscan.shared_scan_bitsliced_static_tiles):
        pbits, pcounts = fn(tdev.tiles, keys, width, n)
        np.testing.assert_array_equal(_u32(tscan.bits_to_canonical(pbits, n)), np.asarray(jbits))
        np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))


def test_consecutive_lo_matches_jax():
    cases = [[3], [3, 4], [4, 3], [0, 1, 2, 3], list(range(5, 1029)), list(range(5, 1030)), [7, 8, 10]]
    for keys in cases:
        arr = np.asarray(keys, np.uint32)
        assert tscan._consecutive_lo(arr) == jscan._consecutive_lo(arr)
        assert tscan._consecutive_lo(torch.from_numpy(arr.view(np.int32))) == jscan._consecutive_lo(arr)


def test_bits_to_canonical_and_popcount():
    width, n = 9, 5000
    values, _, tdev = _columns(width, n, seed=3)
    bits, counts = tscan.interval_scan_tiles(tdev.tiles, 0, 8, width, n)
    canon = tscan.bits_to_canonical(bits, n)
    assert tuple(canon.shape) == (8, tlayout.bitvector_words(n))
    np.testing.assert_array_equal(tscan.popcount_bits(canon).numpy(), counts.numpy())
    np.testing.assert_array_equal(
        _u32(canon), np.asarray(jscan.bits_to_canonical(jnp.asarray(_u32(bits)), n))
    )
