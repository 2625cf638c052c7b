"""The port's unpack and pack against the JAX package's Pallas kernels.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same inputs from a numpy seed and must agree bit for bit.  The
CUDA kernels are held against the plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import unpack as junpack
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import unpack as tunpack
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

WIDTHS = [1, 9, 17, 31]
N = 33 * 128 + 17  # partial block and partial lane tile; B1 = 8


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _rand(width, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << width, size=n, dtype=np.uint64).astype(np.uint32)


def _raw_value_layout(b1, seed):
    """Full 32-bit words in value layout, so pack's masking is exercised."""
    raw = np.random.default_rng(seed).integers(0, 1 << 32, size=(32, b1, 128), dtype=np.uint64)
    return raw.astype(np.uint32)


@pytest.mark.parametrize("width", WIDTHS)
def test_unpack_tiles_matches_jax(width):
    values = _rand(width, N, seed=width)
    jdev = jlayout.pack_device(values, width)
    tdev = tlayout.pack_device(values, width, device="cpu")
    jvals = junpack.unpack_tiles(jdev.tiles, width, interpret=True)
    tvals = tunpack.unpack_tiles(tdev.tiles, width)
    assert tvals.dtype == torch.int32 and tuple(tvals.shape) == (32, 8, 128)
    np.testing.assert_array_equal(_u32(tvals), np.asarray(jvals))
    np.testing.assert_array_equal(_u32(tunpack.unpack_device(tdev)), values)


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_tiles_matches_jax(width):
    raw = _raw_value_layout(8, seed=width + 50)
    jtiles = junpack.pack_tiles(jnp.asarray(raw), width, interpret=True)
    ttiles = tunpack.pack_tiles(torch.from_numpy(raw.view(np.int32)), width)
    np.testing.assert_array_equal(_u32(ttiles), np.asarray(jtiles))


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_device_kernel_matches_jax(width):
    values = _rand(width, N, seed=width + 100)
    jdev = junpack.pack_device_kernel(jnp.asarray(values), width, interpret=True)
    for given in (torch.from_numpy(values.view(np.int32)), torch.from_numpy(values.astype(np.int64))):
        tdev = tunpack.pack_device_kernel(given, width)
        assert tdev.n == jdev.n
        np.testing.assert_array_equal(tdev.to_numpy(), np.asarray(jdev.tiles))


def test_value_layout_conversions_match_jax():
    b1, n = 8, 30_000
    flat = (np.arange(b1 * 128 * 32, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(np.uint32)
    jv = junpack.flat_to_values(jnp.asarray(flat), b1)
    tv = tunpack.flat_to_values(torch.from_numpy(flat.view(np.int32)), b1)
    assert tv.is_contiguous()
    np.testing.assert_array_equal(_u32(tv), np.asarray(jv))
    np.testing.assert_array_equal(_u32(tunpack.values_to_flat(tv, n)),
                                  np.asarray(junpack.values_to_flat(jv, n)))


def test_wrappers_reject_bad_tensors():
    tiles = torch.zeros((9, 8, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        tunpack.unpack_tiles(tiles.to(torch.int64), 9)
    with pytest.raises(ValueError):
        tunpack.unpack_tiles(tiles, 8)  # width does not match axis 0
    with pytest.raises(ValueError):
        tunpack.unpack_tiles(torch.zeros((9, 8, 64), dtype=torch.int32), 9)
    with pytest.raises(ValueError):
        tunpack.unpack_tiles(torch.zeros((9, 128, 8), dtype=torch.int32).transpose(1, 2), 9)
    with pytest.raises(ValueError):
        tunpack.pack_tiles(torch.zeros((31, 8, 128), dtype=torch.int32), 9)
    with pytest.raises(ValueError):
        tunpack.unpack_tiles(torch.zeros((9, 8, 128), dtype=torch.int32, device="meta"), 9)
    with pytest.raises(ValueError):
        tunpack.unpack_tiles(tiles, 32)


def test_cpu_wrappers_launch_nothing():
    fns = (tunpack.unpack_tiles, tunpack.pack_tiles)
    before = [profiling.launch_count(f) for f in fns]
    dev = tunpack.pack_device_kernel(torch.arange(1000, dtype=torch.int32), 10)
    tunpack.unpack_device(dev)
    assert [profiling.launch_count(f) for f in fns] == before
