"""The port's chunked and dynamic tiers against the JAX package.

``shared_scan_chunked_tiles`` and ``shared_scan_dynamic_tiles`` run their
plain versions on CPU tensors; the JAX kernels run in interpret mode, and
the JAX oracle as it is, on the same seeded numpy inputs (b1 = 8 shapes).
Integer results, tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import oracle as joracle
from shared_simd_scan_tpu.ops import scan as jscan
import shared_simd_scan_tpu_torch as port
from shared_simd_scan_tpu_torch.ops import oracle, scan

torch.set_num_threads(1)

WIDTH = 9
N = 3000  # 94 blocks, the last one ragged: b1 = 8


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _keys(k: int, seed: int, values: np.ndarray, width: int = WIDTH) -> np.ndarray:
    """k arbitrary keys: key 0 (which the zero padding must not match),
    0xFFFFFFFF, keys past the domain, a duplicate and values of the column."""
    dom = 1 << width
    edge = [0, 0xFFFFFFFF, dom, 1 << 31, int(values[5]), int(values[5]), int(values[-1])]
    rng = np.random.default_rng(seed)
    keys = np.concatenate([edge, rng.integers(0, dom, size=max(k - len(edge), 0))])[:k]
    return keys.astype(np.uint32)


def _column(width: int, n: int, seed: int):
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n).astype(np.uint32)
    return values, port.pack_device(values, width, device="cpu")


def _torch_keys(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(keys.view(np.int32).copy())


JAX_CASES = [  # (tier, k, block_offset): five interpret-mode calls
    ("chunked", 3, 0),
    ("chunked", 40, 5),
    ("chunked", 64, 0),
    ("dynamic", 3, 0),
    ("dynamic", 40, 0),
]


@pytest.mark.parametrize("tier,k,block_offset", JAX_CASES)
def test_matches_jax_interpret(tier, k, block_offset):
    values, tdev = _column(WIDTH, N, seed=k)
    keys = _keys(k, k + 1, values)
    jtiles = jlayout.pack_device(values, WIDTH).tiles
    np.testing.assert_array_equal(tdev.to_numpy(), np.asarray(jtiles))
    jfn = getattr(jscan, f"shared_scan_{tier}_tiles")
    jbits, jcounts = jfn(jtiles, jnp.asarray(keys), WIDTH, N, interpret=True,
                         block_offset=block_offset)
    fn = getattr(scan, f"shared_scan_{tier}_tiles")
    bits, counts = fn(tdev.tiles, _torch_keys(keys), WIDTH, N, block_offset)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (k, 8, 128)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(_u32(bits), np.asarray(jbits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    if block_offset == 0:
        expect = [int(np.sum(values == key)) for key in keys]
        assert counts.tolist() == expect


@pytest.mark.parametrize("width", [1, 2, 9, 17, 31])
@pytest.mark.parametrize("k", [1, 8, 9, 17, 33, 100])
def test_both_tiers_match_the_oracle(width, k):
    n = 33 * 128 + 17
    values, tdev = _column(width, n, seed=width * 100 + k)
    keys = _keys(k, k, values, width)
    kt = _torch_keys(keys)
    obits, ocounts = oracle.shared_scan(port.pack(values, width, device="cpu"), keys)
    for fn in (scan.shared_scan_chunked_tiles, scan.shared_scan_dynamic_tiles):
        bits, counts = fn(tdev.tiles, kt, width, n)
        np.testing.assert_array_equal(_u32(scan.bits_to_canonical(bits, n)), _u32(obits))
        np.testing.assert_array_equal(counts.numpy(), ocounts.numpy())


def test_past_a_launch_of_keys_and_a_block_offset():
    # more keys than one dynamic launch takes; a shard whose tail lies later
    values, tdev = _column(11, 30_000, seed=4)
    keys = _torch_keys(((np.arange(1100) * 7) % 2100).astype(np.uint32))
    for bo in (0, 2 * 8 * 128 - 40):
        want = scan.shared_scan_tiles_plain(tdev.tiles, keys, 11, 30_000, bo)
        for fn in (scan.shared_scan_chunked_tiles, scan.shared_scan_dynamic_tiles):
            bits, counts = fn(tdev.tiles, keys, 11, 30_000, bo)
            assert torch.equal(bits, want[0]) and torch.equal(counts, want[1])


@pytest.mark.parametrize("k", [scan.CHUNK_KEYS - 1, scan.CHUNK_KEYS, scan.CHUNK_KEYS + 1])
def test_chunked_around_one_chunk_of_keys(k):
    # a ragged last chunk, a whole one, and one key past it; key 0 over the
    # zero padding of the ragged last block
    values, tdev = _column(WIDTH, 1000, seed=k)
    keys = _keys(k, k, values)
    want = scan.shared_scan_tiles_plain(tdev.tiles, _torch_keys(keys), WIDTH, 1000)
    bits, counts = scan.shared_scan_chunked_tiles(tdev.tiles, _torch_keys(keys), WIDTH, 1000)
    assert torch.equal(bits, want[0]) and torch.equal(counts, want[1])
    assert counts.tolist() == [int(np.sum(values == key)) for key in keys]


@pytest.mark.parametrize("tier", ["chunked", "dynamic"])
def test_wrappers_refuse_bad_keys(tier):
    _, tdev = _column(WIDTH, 100, seed=1)
    fn = getattr(scan, f"shared_scan_{tier}_tiles")
    with pytest.raises(ValueError):
        fn(tdev.tiles, torch.zeros(0, dtype=torch.int32), WIDTH, 100)
    with pytest.raises(TypeError):
        fn(tdev.tiles, torch.zeros(3, dtype=torch.int64), WIDTH, 100)
    with pytest.raises(ValueError):
        fn(tdev.tiles, torch.zeros((2, 2), dtype=torch.int32), WIDTH, 100)


# The chunked tier's lookup at its edges, against the JAX oracle: widths 1
# and 31, 12 (the kernel's last width on its direct table) and 13 (its
# first on the search); a chunk of equal keys; k around one chunk; keys
# past the domain and 0xFFFFFFFF; a key repeated across the chunk boundary.
EDGE_SETS = ["equal", "ragged", "one chunk", "across"]


def _edge_keys(case: str, width: int, values: np.ndarray) -> np.ndarray:
    c = scan.CHUNK_KEYS
    if case == "equal":
        return np.full(c, values[3], np.uint32)
    k = {"ragged": c - 1, "one chunk": c, "across": c + 1}[case]
    rng = np.random.default_rng(width * 10 + k)
    keys = rng.integers(0, 1 << width, size=k, dtype=np.uint64).astype(np.uint32)
    keys[:5] = [0, 0xFFFFFFFF, 1 << width, (1 << 32) - 2, values[0]]
    keys[c - 2] = values[-1]
    if case == "across":
        keys[c - 1] = keys[c] = values[5]
    return keys


@pytest.mark.parametrize("case", EDGE_SETS)
@pytest.mark.parametrize("width", [1, 12, 13, 31])
def test_chunked_edges_match_the_jax_oracle(width, case):
    n = 2000
    values, tdev = _column(width, n, seed=width + 7)
    keys = _edge_keys(case, width, values)
    jbits, jcounts = joracle.shared_scan(jlayout.pack(values, width), keys)
    bits, counts = scan.shared_scan_chunked_tiles(tdev.tiles, _torch_keys(keys), width, n)
    np.testing.assert_array_equal(_u32(scan.bits_to_canonical(bits, n)), np.asarray(jbits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


# The dynamic tier's edges, against the JAX oracle: widths 1 and 31, 12 (the
# kernel's last width on its direct table) and 13 (its first on the search);
# k = 63, 64, 65 around one group of 64 rows, with a duplicate across it; k
# = MAX_LAUNCH_KEYS + 1 with a duplicate across the launch boundary; keys
# all past the domain (0xFFFFFFFF among them); a group of equal keys.
DYNAMIC_SETS = ["63", "64", "65", "1025", "past the domain", "equal"]


def _dynamic_keys(case: str, width: int, values: np.ndarray) -> np.ndarray:
    dom = 1 << width
    if case == "equal":
        return np.full(64, values[3], np.uint32)
    if case == "past the domain":
        return np.array([dom, 0xFFFFFFFF, dom + 1, 0xFFFFFFFF, (1 << 32) - 2, dom], np.uint32)
    k = int(case)
    rng = np.random.default_rng(width * 10 + k)
    keys = rng.integers(0, dom, size=k, dtype=np.uint64).astype(np.uint32)
    keys[:5] = [0, 0xFFFFFFFF, dom, (1 << 32) - 2, values[0]]
    keys[k - 1] = keys[5]
    if k > scan.MAX_LAUNCH_KEYS:
        keys[scan.MAX_LAUNCH_KEYS - 1] = keys[scan.MAX_LAUNCH_KEYS] = values[-1]
    return keys


@pytest.mark.parametrize("case", DYNAMIC_SETS)
@pytest.mark.parametrize("width", [1, 12, 13, 31])
def test_dynamic_edges_match_the_jax_oracle(width, case):
    n = 2000
    values, tdev = _column(width, n, seed=width + 11)
    keys = _dynamic_keys(case, width, values)
    jbits, jcounts = joracle.shared_scan(jlayout.pack(values, width), keys)
    bits, counts = scan.shared_scan_dynamic_tiles(tdev.tiles, _torch_keys(keys), width, n)
    np.testing.assert_array_equal(_u32(scan.bits_to_canonical(bits, n)), np.asarray(jbits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
