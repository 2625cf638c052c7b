"""The port's layout, bitvector and oracle modules against the JAX package.

Same inputs, made from a numpy seed, go through both packages; every result
is integer data and must agree bit for bit (tolerance 0).
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import bitvector as jbv
from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import oracle as joracle
from shared_simd_scan_tpu_torch import bitvector as tbv
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.bench import harness as tharness
from shared_simd_scan_tpu_torch.ops import oracle as toracle

torch.set_num_threads(1)

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "reference_golden_9bit.json").read_text()
)
RAMP509 = np.arange(509, dtype=np.uint32)
TINY12 = np.array([1, 2, 3, 3, 2, 1, 1, 2, 3, 1, 2, 3], dtype=np.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _rand(width, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << width, size=n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("width", list(range(1, 32)))
def test_pack_and_tiles_match_jax(width):
    n = 4097 + width  # partial block, partial lane tile
    values = _rand(width, n, seed=width)
    jcol = jlayout.pack(values, width)
    tcol = tlayout.pack(values, width, device="cpu")
    assert tcol.to_bytes() == jcol.to_bytes()
    np.testing.assert_array_equal(_u32(tcol.words), np.asarray(jcol.words))
    jdev = jlayout.to_device(jcol)
    tdev = tlayout.to_device(tcol)
    np.testing.assert_array_equal(tdev.to_numpy(), np.asarray(jdev.tiles))
    np.testing.assert_array_equal(tlayout.pack_device(values, width, device="cpu").to_numpy(),
                                  np.asarray(jdev.tiles))
    np.testing.assert_array_equal(_u32(tlayout.to_canonical(tdev).words), np.asarray(jcol.words))


def test_pack_golden_ramp509():
    assert tlayout.pack(RAMP509, 9, device="cpu").to_bytes() == bytes(GOLDEN["ramp509_packed"])


def test_pack_golden_tiny12():
    assert tlayout.pack(TINY12, 9, device="cpu").to_bytes() == bytes(GOLDEN["tiny12_packed"])


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 9, 15, 16, 17, 24, 31])
def test_from_bytes_matches_jax(width):
    n = 259
    values = _rand(width, n, seed=width + 100)
    data = jlayout.pack(values, width).to_bytes()
    tcol = tlayout.PackedColumn.from_bytes(data, width, n, device="cpu")
    jcol = jlayout.PackedColumn.from_bytes(data, width, n)
    np.testing.assert_array_equal(_u32(tcol.words), np.asarray(jcol.words))
    assert tcol.to_bytes() == data


def test_pack_takes_tensors_and_masks_wide_values():
    values = np.arange(1000, dtype=np.int64) * 977 + (1 << 33)  # bits above 32 and above width
    jcol = jlayout.pack(values.astype(np.uint32), 11)
    for given in (values, torch.from_numpy(values), torch.from_numpy(values.astype(np.uint32).view(np.int32))):
        assert tlayout.pack(given, 11, device="cpu").to_bytes() == jcol.to_bytes()


def test_schedules_match_jax():
    for width in range(1, 32):
        assert tlayout.unpack_schedule(width) == jlayout.unpack_schedule(width)
        assert tlayout.pack_schedule(width) == jlayout.pack_schedule(width)


def test_buffer_contracts_match_jax():
    ns = [0, 1, 31, 32, 33, 509, 4096, 4097, 32768, 32769, 10**6, 477_218_588, (1 << 32) - 1]
    ns += [int(x) for x in np.random.default_rng(7).integers(0, 1 << 32, size=200)]
    for n in ns:
        assert tlayout.num_blocks(n) == jlayout.num_blocks(n)
        assert tlayout.padded_blocks(n) == jlayout.padded_blocks(n)
        assert tlayout.bitvector_words(n) == jlayout.bitvector_words(n)
        for width in (1, 9, 31):
            assert tlayout.packed_nbytes(width, n) == jlayout.packed_nbytes(width, n)
            assert tlayout.packed_words(width, n) == jlayout.packed_words(width, n)


def test_main_path_shape():
    # the reference benchmark's 512 MiB 9-bit column
    n = (512 * 1024 * 1024 * 8) // 9
    assert n == 477_218_588
    assert tlayout.padded_blocks(n) // tlayout.LANES == 116_736


def test_bad_width_and_length_rejected():
    with pytest.raises(ValueError):
        tlayout.pack(TINY12, 0, device="cpu")
    with pytest.raises(ValueError):
        tlayout.pack(TINY12, 32, device="cpu")
    with pytest.raises(ValueError, match="MAX_VALUES"):
        tlayout.PackedColumn(width=1, n=1 << 32, words=torch.zeros(1, dtype=torch.int32))
    tlayout.DeviceColumn(width=1, n=(1 << 32) - 1, tiles=torch.zeros((1, 8, 128), dtype=torch.int32))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a CUDA card")
def test_host_input_without_a_device_asks_for_the_card():
    # entry points put host data on the card unless the caller asks for the
    # CPU; with no card they raise instead of falling back
    data = tlayout.pack(TINY12, 9, device="cpu").to_bytes()
    for call in (lambda: tlayout.pack(TINY12, 9), lambda: tlayout.pack_device(TINY12, 9),
                 lambda: tlayout.pack(TINY12.tolist(), 9),
                 lambda: tlayout.PackedColumn.from_bytes(data, 9, 12),
                 lambda: tbv.from_bytes(data, 12),
                 lambda: tharness.synth_modk(100, 8, 9)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a tensor stays on its own device
    assert tlayout.pack(torch.from_numpy(TINY12.astype(np.int64)), 9).words.device.type == "cpu"


@pytest.mark.parametrize("width", [1, 9, 17, 31])
def test_state_crosses_both_ways(width):
    n = 3000
    values = _rand(width, n, seed=width + 300)
    jdev = jlayout.pack_device(values, width)
    tdev = tlayout.from_jax_numpy(width, n, np.asarray(jdev.tiles), device="cpu")
    assert tdev.tiles.dtype == torch.int32
    np.testing.assert_array_equal(tdev.to_numpy(), np.asarray(jdev.tiles))
    back = jlayout.DeviceColumn(width=width, n=n, tiles=jnp.asarray(tdev.to_numpy()))
    np.testing.assert_array_equal(np.asarray(back.tiles), np.asarray(jdev.tiles))


def test_from_jax_numpy_rejects_bad_input():
    tiles = np.zeros((9, 8, 128), np.uint32)
    with pytest.raises(TypeError):
        tlayout.from_jax_numpy(9, 100, tiles.view(np.int32), device="cpu")
    with pytest.raises(ValueError):
        tlayout.from_jax_numpy(8, 100, tiles, device="cpu")
    with pytest.raises(ValueError):
        tlayout.from_jax_numpy(9, 8 * 128 * 32 + 1, tiles, device="cpu")


def test_u32_i32_roundtrip():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    wide = tlayout.u32(t)
    assert wide.tolist() == [int(x) for x in words]
    np.testing.assert_array_equal(_u32(tlayout.i32(wide)), words)
    np.testing.assert_array_equal(_u32(tlayout.i32(wide + (5 << 32))), words)


# ---------------------------------------------------------------------------
# bitvector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 1024])
def test_bitvector_ops_match_jax(n):
    rng = np.random.default_rng(n)
    mask_a = rng.random(n) < 0.3
    mask_b = rng.random(n) < 0.6
    ja, jb = jbv.from_bool(jnp.asarray(mask_a)), jbv.from_bool(jnp.asarray(mask_b))
    ta, tb = tbv.from_bool(torch.from_numpy(mask_a)), tbv.from_bool(torch.from_numpy(mask_b))
    np.testing.assert_array_equal(_u32(ta), np.asarray(ja))
    np.testing.assert_array_equal(tbv.to_bool(ta, n).numpy(), np.asarray(jbv.to_bool(ja, n)))
    np.testing.assert_array_equal(_u32(tbv.logical_and(ta, tb)), np.asarray(jbv.logical_and(ja, jb)))
    np.testing.assert_array_equal(_u32(tbv.logical_or(ta, tb)), np.asarray(jbv.logical_or(ja, jb)))
    np.testing.assert_array_equal(_u32(tbv.logical_not(ta, n)), np.asarray(jbv.logical_not(ja, n)))
    np.testing.assert_array_equal(_u32(tbv.logical_andnot(ta, tb)),
                                  np.asarray(jbv.logical_andnot(ja, jb)))
    assert int(tbv.popcount(ta)) == int(jbv.popcount(ja)) == int(mask_a.sum())
    for i in sorted({0, 1, n // 2, n - 1, n}):
        assert int(tbv.rank(ta, i)) == int(jbv.rank(ja, i)) == int(mask_a[:i].sum())
    for i in sorted({0, n // 3, n - 1}):
        assert bool(tbv.get_bit(ta, i)) == bool(jbv.get_bit(ja, i)) == bool(mask_a[i])
    for size in (0, 5, n):
        tidx, tcnt = tbv.match_indices(ta, n, size)
        jidx, jcnt = jbv.match_indices(ja, n, size)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        assert int(tcnt) == int(jcnt)
    data = tbv.to_bytes(ta, n)
    assert data == jbv.to_bytes(ja, n)
    np.testing.assert_array_equal(_u32(tbv.from_bytes(data, n, device="cpu")),
                                  np.asarray(jbv.from_bytes(data, n)))


def test_popcount_words_all_bit_patterns():
    words = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555, 0xF0F0F0F0, 0x12345678], np.uint32)
    words = np.concatenate([words, np.random.default_rng(1).integers(0, 1 << 32, 500).astype(np.uint32)])
    got = tbv.popcount_words(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, [bin(int(w)).count("1") for w in words])


# ---------------------------------------------------------------------------
# oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 3, 9, 16, 17, 31])
def test_oracle_matches_jax(width):
    n = 2021
    values = _rand(width, n, seed=width + 400)
    jcol = jlayout.pack(values, width)
    tcol = tlayout.pack(values, width, device="cpu")
    np.testing.assert_array_equal(_u32(toracle.unpack(tcol)), np.asarray(joracle.unpack(jcol)))
    keys = np.array([values[3], values[7], 0, (1 << width) - 1], np.uint32)
    tbits, tcounts = toracle.shared_scan(tcol, keys)
    jbits, jcounts = joracle.shared_scan(jcol, keys)
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    tb1, tc1 = toracle.scan(tcol, int(values[5]))
    jb1, jc1 = joracle.scan(jcol, int(values[5]))
    np.testing.assert_array_equal(_u32(tb1), np.asarray(jb1))
    assert int(tc1) == int(jc1)


def test_oracle_goldens():
    col = tlayout.pack(TINY12, 9, device="cpu")
    bits, hits = toracle.scan(col, 3)
    assert int(hits) == GOLDEN["tiny12_scan3_hits"]
    assert tbv.to_bytes(bits, 12) == bytes(GOLDEN["tiny12_scan3_bits"])
    col = tlayout.pack(RAMP509, 9, device="cpu")
    bits, hits = toracle.scan(col, 3)
    assert int(hits) == GOLDEN["ramp509_scan3_hits"]
    assert tbv.to_bytes(bits, 509) == bytes(GOLDEN["ramp509_scan3_bits"])
    np.testing.assert_array_equal(toracle.unpack(col)[:16].numpy(),
                                  GOLDEN["ramp509_decompressed_first16"])
