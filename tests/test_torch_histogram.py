"""The port's value histogram against the JAX package.

The same column (from a numpy seed) goes to both packages: the JAX one
runs its Pallas kernels in interpret mode, as its own tests do; the port
runs the plain torch versions of its kernels on CPU tensors.  Counts must
be equal (tolerance 0) and equal numpy's.  The span kernel is reached with
k of 49-64 at widths 6-7: the JAX straight-line body's trace grows with k.
The CUDA kernels are held against the plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import histogram_device
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import scan as tscan
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 4241  # ragged: the last block holds 17 values, then padding blocks


def _column(width, n=N, seed=0):
    """(values, JAX DeviceColumn, port DeviceColumn crossed with from_jax_numpy)."""
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n, dtype=np.uint64)
    values = values.astype(np.uint32)
    jdev = jlayout.pack_device(values, width)
    tdev = tlayout.from_jax_numpy(width, n, np.asarray(jdev.tiles), "cpu")
    return values, jdev, tdev


def _lo(lo: int) -> torch.Tensor:
    return torch.from_numpy(np.asarray([lo], np.uint32).view(np.int32).copy())


def _same(tcounts, jcounts, values=None, lo=0):
    got = tcounts.numpy()
    assert tcounts.dtype == torch.int64
    np.testing.assert_array_equal(got, np.asarray(jcounts).astype(np.int64))
    if values is not None:
        expect = [(values == lo + j).sum() for j in range(got.shape[0])]
        np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("width", [5, 6])  # the chunked DAG (k = 32) and the span (k = 64)
def test_full_domain_histogram_matches_jax(width):
    values, jdev, tdev = _column(width, seed=width)
    _same(histogram_device(tdev), jscan.histogram_device(jdev, interpret=True), values)


@pytest.mark.parametrize("lo,k", [(100, 40), (3, 5)])
def test_tensor_lo_matches_jax_traced_lo(lo, k):
    values, jdev, tdev = _column(9, seed=lo)
    jcounts = jscan.histogram_device(jdev, jnp.uint32(lo), k, interpret=True)
    _same(histogram_device(tdev, _lo(lo), k), jcounts, values, lo)


@pytest.mark.parametrize("single_pass", [False, True])
def test_histogram_dag_tiles_both_forms_match_jax(single_pass):
    width, lo, k = 7, 3, 57
    values, jdev, tdev = _column(width, seed=11)
    jcounts = jscan.histogram_dag_tiles(jdev.tiles, lo, k, width, N, interpret=True,
                                        single_pass=single_pass)
    _same(tscan.histogram_dag_tiles(tdev.tiles, lo, k, width, N, single_pass=single_pass),
          jcounts, values, lo)


def test_block_offset_matches_jax():
    # a shard whose tail lies further on: the validity word moves with it
    width, lo, k, offset = 6, 2, 49, 40
    _, jdev, tdev = _column(width, seed=12)
    _same(tscan.histogram_tiles(tdev.tiles, lo, k, width, N, offset),
          jscan.histogram_tiles(jdev.tiles, jnp.uint32(lo), k, width, N, interpret=True,
                                block_offset=offset))
    _same(tscan.histogram_dag_tiles(tdev.tiles, lo, k, width, N, offset),
          jscan.histogram_dag_tiles(jdev.tiles, lo, k, width, N, interpret=True,
                                    block_offset=offset))


def test_top_of_uint32_differs_by_tier_as_in_jax():
    # a runtime lo wraps lo + j past 2^32 onto the small values; a concrete
    # lo counts keys >= 2^width as 0.  The port keeps each JAX tier's rule.
    width, k = 5, 8
    lo = (1 << 32) - 3
    values, jdev, tdev = _column(width, seed=13)
    jwrap = jscan.histogram_device(jdev, jnp.uint32(lo), k, interpret=True)
    twrap = histogram_device(tdev, _lo(lo), k)
    _same(twrap, jwrap)
    assert twrap.tolist() == [0, 0, 0] + [int((values == v).sum()) for v in range(5)]
    jdag = jscan.histogram_device(jdev, lo, k, interpret=True)
    tdag = histogram_device(tdev, lo, k)
    _same(tdag, jdag)
    assert tdag.tolist() == [0] * k


@pytest.mark.parametrize("width", [1, 9, 12])
def test_whole_domain_window_and_one_key_short(width):
    # k = 2^W with lo 0 is the bins kernel's whole-domain path on the card;
    # k = 2^W - 1 its window path.  Both plain versions (runtime and host
    # lo) against numpy, and at width 12 against the JAX runtime-lo kernel
    # (one interpret-mode call; k = 4095 is its prefix)
    values, jdev, tdev = _column(width, seed=20 + width)
    dom = 1 << width
    expect = np.bincount(values, minlength=dom)
    jcounts = (np.asarray(jscan.histogram_tiles(jdev.tiles, jnp.uint32(0), dom, width, N,
                                                interpret=True)) if width == 12 else expect)
    for k in (dom, dom - 1):
        if k == 0:
            continue
        for got in (tscan.histogram_tiles(tdev.tiles, _lo(0), k, width, N),
                    tscan._histogram_span_tiles(tdev.tiles, 0, k, width, N)):
            _same(got, jcounts[:k], values)


def test_wide_domain_is_capped_at_4096():
    width, n = 16, 8000
    values = np.random.default_rng(6).integers(0, 1 << width, size=n).astype(np.uint32)
    tdev = tlayout.pack_device(values, width, device="cpu")
    counts = histogram_device(tdev)
    assert counts.shape == (4096,)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(values[values < 4096],
                                                              minlength=4096))
    # the same counts from the runtime-lo kernel and the forced span form
    assert torch.equal(tscan.histogram_tiles(tdev.tiles, 0, 4096, width, n), counts)
    for k in (0, 5000):
        with pytest.raises(ValueError, match="histogram supports"):
            histogram_device(tdev, k=k)
        with pytest.raises(ValueError, match="histogram supports"):
            histogram_device(tdev, _lo(0), k=k)
    with pytest.raises(ValueError, match="uint32"):
        histogram_device(tdev, -1, 8)


def test_programs_and_dispatch():
    # 48 < k <= 512 takes the span tier, other k the chunked programs
    calls = []
    real = {fn: getattr(tscan, fn) for fn in ("_histogram_span_tiles", "_histogram_chunked_tiles")}
    width, n = 9, 3000
    tiles = tlayout.pack_device(np.arange(n) % 512, width, device="cpu").tiles
    try:
        for name, fn in real.items():
            setattr(tscan, name, lambda *a, name=name, fn=fn: calls.append(name) or fn(*a))
        for k in (48, 49, 512, 513):
            tscan.histogram_dag_tiles(tiles, 0, k, width, n)
    finally:
        for name, fn in real.items():
            setattr(tscan, name, fn)
    assert calls == ["_histogram_chunked_tiles", "_histogram_span_tiles",
                     "_histogram_span_tiles", "_histogram_chunked_tiles"]
    # the span tier against the JAX span kernel: a window running past the
    # domain, and one past 2^32 - 1, which counts nothing (no wrap)
    values, jdev, tdev = _column(7, seed=14)
    for lo, k in ((128 - 20, 64), ((1 << 32) - 3, 40)):
        jcounts = jscan._histogram_span_tiles_impl(jdev.tiles, lo, k, 7, N, None, True, 0)
        _same(tscan._histogram_span_tiles(tdev.tiles, lo, k, 7, N), jcounts, values, lo)
    # on CPU tensors no kernel launches
    fns = (tscan.histogram_tiles, tscan._histogram_span_tiles, tscan._histogram_chunked_tiles)
    before = [profiling.launch_count(f) for f in fns]
    histogram_device(tlayout.DeviceColumn(width, n, tiles))
    histogram_device(tlayout.DeviceColumn(width, n, tiles), _lo(0), 40)
    assert [profiling.launch_count(f) for f in fns] == before


@pytest.mark.parametrize("width,lo,k", [(1, 0, 2), (4, 0, 16), (7, (1 << 32) - 3, 40)])
def test_chunked_tier_matches_jax_chunked_programs(width, lo, k):
    # the port counts all k keys in one launch, the JAX package runs its
    # AND-DAG programs (interpret mode): the full domain at widths 1 and 4,
    # and keys from 2^32 - 3, which count 0 (no wrap)
    values, jdev, tdev = _column(width, seed=30 + width)
    jcounts = jscan.histogram_dag_tiles(jdev.tiles, lo, k, width, N, interpret=True,
                                        single_pass=False)
    _same(tscan._histogram_chunked_tiles(tdev.tiles, lo, k, width, N), jcounts, values, lo)
    _same(tscan._histogram_chunked_tiles(tdev.tiles, lo, k, width, N, 2),
          jscan.histogram_dag_tiles(jdev.tiles, lo, k, width, N, interpret=True,
                                    single_pass=False, block_offset=2))


def test_chunked_tier_against_numpy_at_widths_10_and_12():
    # the full domain at width 10 (k = 1024, four of the JAX package's
    # static groups: its interpret mode takes ~50 s, so numpy stands in),
    # a 1000-key window at width 12 and one running past its domain
    for width, lo, k in ((10, 0, 1024), (12, 100, 1000), (12, 4000, 1000)):
        values, _, tdev = _column(width, seed=40 + width)
        expect = np.bincount(values, minlength=lo + k)[lo: lo + k]
        np.testing.assert_array_equal(
            tscan._histogram_chunked_tiles(tdev.tiles, lo, k, width, N).numpy(), expect)


def test_histogram_dag_passes_is_one_for_every_k():
    # both tiers count every k in one pass over the packed column
    assert [tscan.histogram_dag_passes(k) for k in (1, 40, 48, 49, 512, 513, 1024, 4096)] == [1] * 8
    with pytest.raises(ValueError, match="histogram supports"):
        tscan.histogram_dag_passes(4097)


def test_fold_counts_rule_follows_the_committed_sweep():
    # the chunked tier's choice between the static fold's counts form (on
    # the keys inside the domain) and the bins kernel (0), as
    # bench/redesign_sweep.py histdag fixed it: every window at width 1;
    # windows short of the whole domain with at most 8 keys inside it up to
    # width 4 and 2 up to width 8; nothing else
    cases = {(1, 0, 2): 2, (1, 0, 4096): 2, (1, 1, 1): 1, (1, 2, 40): 0, (2, 0, 2): 2,
             (4, 0, 8): 8, (4, 3, 8): 8, (4, 12, 40): 4, (5, 0, 2): 2, (8, 7, 2): 2,
             (2, 0, 4): 0, (4, 0, 16): 0, (4, 0, 9): 0, (5, 0, 3): 0, (8, 0, 256): 0,
             (9, 0, 2): 0, (9, 100, 40): 0, (12, 0, 4096): 0, (4, 0, 4096): 0,
             (4, (1 << 32) - 3, 40): 0}
    assert {case: tscan._histogram_fold_keys(*case) for case in cases} == cases
