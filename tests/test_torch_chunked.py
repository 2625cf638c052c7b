"""The port's chunked and dynamic compare tiers against the JAX package.

``shared_scan_chunked_tiles`` and ``shared_scan_dynamic_tiles`` run their
plain versions on CPU tensors; the JAX kernels run in interpret mode on the
same seeded numpy inputs (b1 = 8 shapes).  Integer results, tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
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
